"""tick.kernels_per_tick.split4: ``tick.kernels_per_tick`` in the cell split over four cards
(``df1d_w1.split4``), which reports ``split_rate``."""
from readers import same_as

read = same_as("tick.kernels_per_tick")
