"""engine.ticks_per_vms.single: ``engine.ticks_per_vms`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("engine.ticks_per_vms")
