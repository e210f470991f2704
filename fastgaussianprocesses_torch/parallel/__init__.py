"""SPMD layer over ``torch.distributed`` (counterpart of
``fastgaussianprocesses_tpu/parallel``): one process a card, each rank holding
only its own block of a sharded tensor, every collective explicit."""
