"""Sharding over torch.distributed: the (data, fsdp) mesh and the flat
ZeRO state layout (`mesh.py`), and Megatron tensor parallelism for the
SD3 MMDiT (`tensor_parallel.py`)."""
