"""Helpers shared by the port's parity tests against the JAX package
(tests/test_torch_render.py, test_torch_render_tlas.py,
test_torch_scene.py): JAX's random draws replayed through the port's
Sampler, a tensor-to-numpy view and a quad's two triangles. Imported
only by test files that have already skipped without torch."""

import jax
import numpy as np
import torch

from tinybvh_tpu_torch.render import pathtracer as ppt


class JaxDraws(ppt.Sampler):
    """Replays jax.random's draws on the JAX tracers' key schedule: a
    bounce splits its key six ways (trace_paths, pathtracer.py:259), a
    sample of render splits the master key three ways (:425)."""

    def __init__(self, key):
        self.master = self.key = key

    def bounce(self, n_rays, n_lights, device):
        self.key, k1, k2, k3, k4, k5 = jax.random.split(self.key, 6)
        li = np.asarray(jax.random.randint(k1, (n_rays,), 0, n_lights))
        rs = [torch.from_numpy(np.array(jax.random.uniform(k, (n_rays,))))
              for k in (k2, k3, k4, k5)]
        return (torch.from_numpy(li.astype(np.int64)).to(device),
                *(r.to(device) for r in rs))

    def jitter(self, height, width, device):
        self.master, kj, self.key = jax.random.split(self.master, 3)
        jit = np.array(jax.random.uniform(kj, (height, width, 2)))
        return torch.from_numpy(jit).to(device)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _quad(a, b, c, d):
    a, b, c, d = (np.asarray(x, np.float32) for x in (a, b, c, d))
    return np.stack([[a, b, c], [a, c, d]])
