"""Each model type's configuration file read as the program's
``ModelConfig`` (``port_config``).  The only modules here, beside
``drivers/``, that import the program."""
