"""Models of the port: parameter specs, layers, attention, the Mamba-2 SSD
block, the DiT and SSM backbone and the flow adapter."""
