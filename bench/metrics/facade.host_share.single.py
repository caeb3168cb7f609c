"""facade.host_share.single: ``facade.host_share`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("facade.host_share")
