"""Hand-written Hopper kernels, their plain torch versions (``ref``) and the
device dispatchers (``ops``)."""
