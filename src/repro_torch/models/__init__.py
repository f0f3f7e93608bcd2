"""Models of the port: parameter specs, layers, attention, the DiT backbone
and the flow adapter."""
