"""Llama-4-Scout-17B-16E — MoE top-1 + shared expert, iRoPE chunked
attention with periodic global layers [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128,
    n_experts=16, experts_per_token=1, n_shared_experts=1, d_ff_expert=8192,
    attention_chunk=8192, global_attn_every=4,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512, loss_chunk=512,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
