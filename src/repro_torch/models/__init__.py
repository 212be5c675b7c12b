"""The model stack of the port: ``layers`` (init, norms), ``ssm`` (Mamba2),
``model`` (``DecoderLM``) and ``convert`` (JAX params -> ``state_dict``)."""
