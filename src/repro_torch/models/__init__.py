"""The LM substrate of the port: dense decoder blocks, GQA attention, RWKV-6
blocks (the ssm family) and the family-dispatched LM entry points
(``models/lm.py``).  Parameters are the
JAX package's dict trees, with tensors in place of arrays."""
