"""Graph execution: the executor (eager per-op dispatch, CUDA-graph
capture on the card) and the device runtime handle."""
