"""incubate: gradient merge (``incubate.optimizer``)."""
