"""The port's copies of the JAX package's kernel probes (≙ the Pallas
probe scripts in benchmarks/), each a hand-written CUDA kernel with a
plain PyTorch twin and a driver that times it on the card:

  gather       kernel H, the in-kernel gather forms
               (benchmarks/pallas_gather_probe.py, pallas_gather_probe2.py):
               python -m tinybvh_tpu_torch.probes.gather
  mt_ablation  kernel I, kernel B's tile loop with one part taken out at a
               time (benchmarks/mt_ablation_probe.py):
               python -m tinybvh_tpu_torch.probes.mt_ablation [kpt...]
               [--scattered]

The drivers run on the card and raise without one; their inputs come
from numpy generators seeded explicitly. Their timing helpers are in
tinybvh_tpu_torch._timing."""
