"""Row-sharded (``sp``) and batch-sharded (``dp``) solves over a mesh of
torch devices, driven from one process."""
