"""kernel.drain_tick.roofline.single: ``kernel.drain_tick.roofline`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("kernel.drain_tick.roofline")
