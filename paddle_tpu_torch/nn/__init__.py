"""Neural-network functionals of the port (``nn.functional``)."""
