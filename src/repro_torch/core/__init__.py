"""NetMax core, host side: link-time model, consensus math, Algorithm-3
policy generation, the Network Monitor and the convergence theory (numpy
copies of the JAX package's modules)."""
