"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set to a
lower ``power.limit`` runs slower under load; the harness prints the
limit beside every run."""

BF16 = 989e12      # FLOP/s, bf16 / fp16 tensor cores
TF32 = 495e12      # FLOP/s, TF32 tensor cores
FP32 = 67e12       # FLOP/s, fp32 on the CUDA cores
FP64 = 67e12       # FLOP/s, fp64 tensor cores
# fp32-accurate products on the tensor cores as 3xTF32 (three TF32
# products each): the fastest fp32-accurate rate the card offers
FP32_3XTF32 = TF32 / 3
BYTES = 3.35e12    # HBM3 bytes/s
