"""The general generator of traffic: a mix's data file names a kind of
ray batch (rays/<kind>.py) and gives its parameters; this makes the
mix's pool of batches on the scene's device from the seed, all in a few
large calls. A kind makes its batches one by one (`make(..., index)`),
or the whole pool at once (`make_pool`), with the seconds it spent in
the plain reference, which set-up does not count. A kind sees the scene
only through what every scene kind gives (harness/spec.py): its device,
its world box and the plain reference's hits."""

from __future__ import annotations

import torch

from harness.spec import load_module


def derive(seed: int, stream: int) -> int:
    """A seed of its own for each stream of random numbers of a run."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (
        2 ** 63 - 1)


def make_batches(traffic: dict, base, scene, seed: int):
    """(o, d, reference_s): o and d (pool, R, 3) float32 on the scene's
    device, the mix's `pool` batches made from the seed, and the seconds
    spent in the plain reference making them."""
    kind = load_module(base, "rays", traffic["rays"])
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(derive(seed, 1))
    if hasattr(kind, "make_pool"):
        return kind.make_pool(scene, traffic, gen, base)
    made = [kind.make(scene, traffic, gen, i)
            for i in range(int(traffic["pool"]))]
    R = made[0][0].shape[0]
    if any(o.shape[0] != R for o, _ in made):
        raise ValueError("every batch of a mix must hold the same rays")
    return (torch.stack([o for o, _ in made]),
            torch.stack([d for _, d in made]), 0.0)
