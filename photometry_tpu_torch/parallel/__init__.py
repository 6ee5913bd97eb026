"""Several worker processes draining one todo list (the task-pull scheduler),
and the host-level work split of ``multihost``."""
