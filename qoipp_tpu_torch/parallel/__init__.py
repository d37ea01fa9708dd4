"""Data- and sequence-parallel codec over torch.distributed (the port of
``qoipp_tpu.parallel``): meshes and collectives (``mesh``), the sharded
codec (``sharded``), a local multi-process launcher (``launch``) and the
multi-rank dry run (``dryrun``)."""
