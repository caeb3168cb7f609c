"""kernel.link_demand.roofline.single: ``kernel.link_demand.roofline`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("kernel.link_demand.roofline")
