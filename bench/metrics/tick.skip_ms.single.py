"""tick.skip_ms.single: ``tick.skip_ms`` in the one-member cell
(``df1d_w1.single``), which reports ``scenario_rate``."""
from readers import same_as

read = same_as("tick.skip_ms")
