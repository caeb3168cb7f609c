"""facade.host_share.split4: ``facade.host_share`` in the cell split over four cards
(``df1d_w1.split4``), which reports ``split_rate``."""
from readers import same_as

read = same_as("facade.host_share")
