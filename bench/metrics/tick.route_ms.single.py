"""tick.route_ms.single: ``tick.route_ms`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("tick.route_ms")
