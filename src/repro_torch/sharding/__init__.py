"""Sharding specs of the model mesh: which mesh axes shard each parameter
and each input (:mod:`repro_torch.sharding.specs`)."""
