"""tick.roofline.split4: ``tick.roofline`` in the cell split over four cards
(``df1d_w1.split4``), which reports ``split_rate``."""
from readers import same_as

read = same_as("tick.roofline")
