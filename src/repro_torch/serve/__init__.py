"""Personalized serving of the port: a (team, device)-keyed
:class:`ModelStore` exported from a trained federated state, and a
:class:`PersonalizedServer` that batches requests tagged with their
principal and resolves each one down the device -> team -> global tier
ladder, with a Zipf traffic replay that measures it. (The reference's
LLM decode loop, ``repro/serve/engine.py``, is not ported yet.)"""
from repro_torch.serve.personalized import (PersonalizedServer,
                                            replay_traffic, zipf_requests)
from repro_torch.serve.store import ENCODINGS, ModelStore

__all__ = ["ENCODINGS", "ModelStore", "PersonalizedServer",
           "replay_traffic", "zipf_requests"]
