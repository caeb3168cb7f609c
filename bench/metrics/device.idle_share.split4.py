"""device.idle_share.split4: ``device.idle_share`` in the cell split over four cards
(``df1d_w1.split4``), which reports ``split_rate``."""
from readers import same_as

read = same_as("device.idle_share")
