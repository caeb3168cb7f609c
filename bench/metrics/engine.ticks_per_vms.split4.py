"""engine.ticks_per_vms.split4: ``engine.ticks_per_vms`` in the cell split over four cards
(``df1d_w1.split4``), which reports ``split_rate``."""
from readers import same_as

read = same_as("engine.ticks_per_vms")
