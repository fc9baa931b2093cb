"""Sharding over a ("dp", "tp") device mesh on ``torch.distributed``: the
mesh and its placements, multi-process setup, the sharded kNN search, the
sharded predict and train steps, sharded checkpoints and the sharded
classifier facade.  Everything here runs inside a process group that the
caller (or ``multihost.initialize_distributed``) set up; without one it
raises rather than run unsharded."""
