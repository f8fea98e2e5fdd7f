"""Serving of the port. Two shapes live here, as in the reference:

* personalized serving: a (team, device)-keyed :class:`ModelStore`
  exported from a trained federated state, and a
  :class:`PersonalizedServer` that batches requests tagged with their
  principal and resolves each one down the device -> team -> global tier
  ladder, with a Zipf traffic replay that measures it;
* LLM serving: :class:`ServeEngine` (``serve/engine.py``), prefill once
  and one-token decode steps against a KV cache, with the samplers of
  ``serve/sampler.py`` and the command line ``python -m
  repro_torch.serve.llm``.
"""
from repro_torch.serve.engine import (ServeEngine, make_decode_step,
                                      make_prefill_step)
from repro_torch.serve.personalized import (PersonalizedServer,
                                            replay_traffic, zipf_requests)
from repro_torch.serve.store import ENCODINGS, ModelStore

__all__ = ["ENCODINGS", "ModelStore", "PersonalizedServer", "ServeEngine",
           "make_decode_step", "make_prefill_step", "replay_traffic",
           "zipf_requests"]
