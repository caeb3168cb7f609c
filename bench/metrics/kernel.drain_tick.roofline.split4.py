"""kernel.drain_tick.roofline.split4: ``kernel.drain_tick.roofline`` in the cell split over four cards
(``df1d_w1.split4``), which reports ``split_rate``."""
from readers import same_as

read = same_as("kernel.drain_tick.roofline")
