"""Models of the port: the paper models (batched over devices) and the
LLM zoo's decoder (``layers``, ``attention``, ``moe``, ``transformer``,
``model``)."""
