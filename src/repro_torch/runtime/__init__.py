"""The multi-device runtime of the torch port: logical sharding rules
(``sharding``) and the explicit collectives of the parallel layers
(``collectives``), over a ``torch.distributed`` device mesh."""
