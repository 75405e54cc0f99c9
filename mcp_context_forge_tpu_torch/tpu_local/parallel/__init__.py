"""Parallel layers of the model. So far the routed MoE FFN on one card;
the multi-GPU paths (tensor, sequence and pipeline parallelism) are not
ported yet."""
