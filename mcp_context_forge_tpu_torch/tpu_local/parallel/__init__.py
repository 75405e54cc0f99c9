"""Parallel layers of the model over ``torch.distributed`` (NCCL on the
card, gloo on the CPU): the mesh (``mesh.py``), the sharding rules
(``sharding.py``), collectives with gradients for tensor parallelism
(``collectives.py``), ring and Ulysses sequence-parallel attention
(``ring_attention.py``), the GPipe forward (``pipeline.py``), and the routed
MoE FFN, one card's expert scan and the capacity dispatch over an
``expert`` axis (``moe.py``). The DP x TP train step is ``train.py``'s."""
