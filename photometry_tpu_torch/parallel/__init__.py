"""Several worker processes draining one todo list (the task-pull scheduler),
device meshes and the sharded programs over them (``mesh``, ``sharded``),
and the multi-process layer over ``torch.distributed`` (``multihost``)."""
