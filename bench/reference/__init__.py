"""The plain reference of the simulator that the benchmark judges the port
by: plain PyTorch and numpy, importing nothing of the program. It reads
the scenario file and the member seeds that the benchmark hands both
sides and works out again the programs, fabric, placements, routes and
state, then each member's report (:func:`study.member_reports`)."""
