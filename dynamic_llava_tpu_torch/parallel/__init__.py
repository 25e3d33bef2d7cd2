"""Multi-rank training and inference (counterpart of
``dynamic_llava_tpu/parallel``): the four-axis mesh and parameter sharding
(``sharding``), and the GPipe layer runner (``pipeline``), on
``torch.distributed``."""
