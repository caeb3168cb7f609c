"""tick.kernels_per_tick.single: ``tick.kernels_per_tick`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("tick.kernels_per_tick")
