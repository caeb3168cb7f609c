"""device.idle_share.trace: ``device.idle_share`` in a cell of the online
scheduler (a trace configuration), which reports ``trace_rate``: its boundary
profile spans two whole scheduler rounds of the second repeat (rounds
2 and 3), each a host round (view, queue policy, slot surgery) and its
window's replays."""
from readers import same_as

read = same_as("device.idle_share")
