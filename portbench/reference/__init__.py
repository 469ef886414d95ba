"""Plain PyTorch references of the benchmark's models, in fp32 with TF32
off.  They import neither the program nor JAX; they read the weights that
``pbcore.weights`` draws from the run's seed, a layer at a time."""
