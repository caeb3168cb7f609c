"""The network simulator: fabrics, routing, placement, engine, metrics."""
