"""Neural-network functionals (``nn.functional``) and the layers of the
BERT encoder (``nn.layer``)."""
