"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: every test skips without a CUDA device. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances (as tests/test_packet2.py:141-160): cull survivor keys and
counts exactly equal; prim equal; t within rtol = atol = 1e-4; u, v
within 1e-3. Both kernels round every multiply and add separately in the
twins' order, so they are expected to agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tinybvh_tpu_torch import BVH  # noqa: E402
from tinybvh_tpu_torch.core.intersect import brute_force_closest  # noqa: E402
from tinybvh_tpu_torch.core.rays import make_rays  # noqa: E402
from tinybvh_tpu_torch.io.loaders import random_tris  # noqa: E402
from tinybvh_tpu_torch.traverse import packet2  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    tris = random_tris(3000, seed=0)
    bvh = BVH(tris, device="cuda")
    return tris, bvh


def _camera_rays(T=16, seed=3):
    rng = np.random.default_rng(seed)
    eye = np.array([5.0, 5.0, -8.0], np.float32)
    d = []
    for _ in range(T):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        gx, gy = np.meshgrid((np.arange(16) + 0.5) / 16 * 0.05,
                             (np.arange(16) + 0.5) / 16 * 0.05)
        dd = np.stack([cx + gx, cy + gy, np.ones_like(gx)], -1)
        dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
        d.append(dd.reshape(-1, 3))
    d = np.concatenate(d).astype(np.float32)
    return np.broadcast_to(eye, d.shape).copy(), d


def _capture(monkeypatch, name):
    """Record the arguments of every packet2.<name> call."""
    calls = []
    real = getattr(packet2, name)

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(packet2, name, rec)
    return calls


def _trace(bvh, rays, **kw):
    return packet2.intersect_packets2(bvh.bvh8, bvh.packet_aux, rays,
                                      retrace=False, **kw)


@pytest.mark.parametrize("span_mult,max_leaves",
                         [(1, 256), (2, 512), (1, 16)])
def test_cull_kernel_matches_plain(scene, monkeypatch, span_mult,
                                   max_leaves):
    """Kernel A: per-tile survivor keys (in worklist order) and counts
    equal the plain twin's; max_leaves=16 overflows k_cap."""
    _, bvh = scene
    o, d = _camera_rays()
    calls = _capture(monkeypatch, "cull")
    _trace(bvh, make_rays(o, d, device="cuda"), max_leaves=max_leaves,
           span_mult=span_mult)
    (args,) = calls
    k_gpu, c_gpu = packet2._cull_cuda(*args)
    k_ref, c_ref = packet2._cull_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(c_gpu, c_ref)
    assert torch.equal(k_gpu, k_ref)
    if max_leaves == 16:
        assert bool((c_ref > args[6]).any())


@pytest.mark.parametrize("any_hit,pack", [(False, 2), (True, 2),
                                          (False, 1)])
def test_mt_kernel_matches_plain(scene, monkeypatch, any_hit, pack):
    """Kernel B on the same offsets/gates as the plain twin; pack=1 is the
    one-triangle-per-row table layout."""
    _, bvh = scene
    o, d = _camera_rays()
    aux = (bvh.packet_aux if pack == 2 else
           packet2.build_packet_aux_host(bvh._bvh8_host, pack=1,
                                         device="cuda"))
    calls = _capture(monkeypatch, "mt_fused")
    packet2.intersect_packets2(bvh.bvh8, aux, make_rays(o, d, device="cuda"),
                               max_leaves=512, retrace=False,
                               any_hit=any_hit,
                               t_max=20.0 if any_hit else 1e30)
    (args,) = calls
    got = packet2._mt_fused_cuda(*args)
    ref = packet2._mt_fused_plain(*args)
    torch.cuda.synchronize()
    t, i, u, v, p = (x.cpu().numpy() for x in got)
    tr, ir, ur, vr, pr = (x.cpu().numpy() for x in ref)
    np.testing.assert_array_equal(p, pr)
    np.testing.assert_array_equal(i, ir)
    np.testing.assert_allclose(t, tr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u, ur, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(v, vr, rtol=1e-3, atol=1e-3)


def test_launch_rejects_bad_inputs(scene, monkeypatch):
    """A wrong dtype, a mix of devices or a bad shape raises; nothing
    falls back to the CPU."""
    _, bvh = scene
    o, d = _camera_rays(T=8)
    calls = _capture(monkeypatch, "mt_fused")
    _trace(bvh, make_rays(o, d, device="cuda"))
    args = list(calls[0])
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(TypeError):
        packet2.mt_fused(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        packet2.mt_fused(*bad)
    bad = list(args)
    bad[4] = args[4][:, :6].contiguous()
    with pytest.raises(ValueError):
        packet2.mt_fused(*bad)


def test_tf32_forced_on_changes_nothing(scene):
    _, bvh = scene
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h0, _ = _trace(bvh, rays)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        h1, _ = _trace(bvh, rays)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert torch.equal(h0.prim, h1.prim)
    assert torch.equal(h0.t, h1.t)


def test_api_on_cuda_matches_oracle(scene):
    tris, bvh = scene
    o, d = _camera_rays()
    rays = make_rays(o, d, device="cuda")
    before = dict(packet2.LAUNCHES)
    h = bvh.intersect(rays)
    assert packet2.LAUNCHES["cull"] > before["cull"]
    assert packet2.LAUNCHES["mt_fused"] > before["mt_fused"]
    ref = brute_force_closest(rays, bvh.tris)
    hp, rp = h.prim.cpu().numpy(), ref.prim.cpu().numpy()
    np.testing.assert_array_equal(hp, rp)
    m = rp >= 0
    assert 0.0 < m.mean() < 1.0
    np.testing.assert_allclose(h.t.cpu().numpy()[m], ref.t.cpu().numpy()[m],
                               rtol=1e-4, atol=1e-4)
