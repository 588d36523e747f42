"""Plain PyTorch references: one module a model type (``qwen2``,
``mamba2``) and the Parle equations (``parle``).  They import neither
JAX nor the JAX package nor anything of ``repro_torch``, and take
nothing that the program made: the benchmark makes the weights and the
inputs (``weights.py``) and hands the same to both sides."""
