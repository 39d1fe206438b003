"""Ranks over ``torch.distributed`` (``mesh``) and the vocab-sharded
embedding engine (``embedding``)."""
