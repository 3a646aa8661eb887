"""The parallel layer's model-free helpers over grids of shapes, held against
the JAX package where it has the same function and against the invariant
that makes height sharding exact where it has none: the window offsets and
crops, the shardability checks, the receptive radii, the trunk's row mask,
the halo exchange, the per-process batch split and steps per epoch, the
rendezvous refusals and the mesh's placement of shards on cards. Every case
runs in milliseconds; the models' sharded paths are in
tests/test_torch_parallel.py.

Tolerances: none. Every comparison here is of integers, of copied rows or of
0/1 masks, so it is exact."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.cli import common_cli as j_common_cli
from mobilesuperresolution_tpu.data import isr as j_isr
from mobilesuperresolution_tpu.parallel import distributed as j_distributed
from mobilesuperresolution_tpu.parallel import halo as j_halo
from mobilesuperresolution_tpu.parallel import vsr_spatial as j_vsr_spatial
from mobilesuperresolution_tpu_torch.cli import common_cli
from mobilesuperresolution_tpu_torch.data import isr
from mobilesuperresolution_tpu_torch.parallel import distributed, halo, mesh, vsr_spatial

# (H, shards, radius) that _check_shardable accepts
SHARDABLE = [
    (8, 2, 1), (8, 2, 2), (12, 2, 3), (12, 3, 2), (12, 4, 1), (16, 2, 4), (16, 4, 2), (18, 3, 3),
    (20, 2, 5), (20, 4, 2), (20, 5, 2), (24, 6, 2), (24, 8, 1), (30, 5, 3), (32, 4, 4), (32, 8, 2),
    (36, 3, 6), (36, 6, 3), (40, 4, 5), (48, 4, 6), (48, 8, 3), (60, 5, 6), (64, 8, 4),
]


@pytest.mark.parametrize("h,n,radius", SHARDABLE)
def test_windows_cover_every_row_with_its_receptive_field(h, n, radius):
    """The offsets equal JAX's; every window lies in the image; the kept rows
    of the windows cover the image once, in order; and every kept row's
    receptive field, clipped to the image, lies inside its window, which is
    why a window reproduces the full frame's rows."""
    offsets = halo.shard_offsets(h, n, radius)
    assert offsets == j_halo.shard_offsets(h, n, radius)
    hs, win = h // n, h // n + 2 * radius
    kept = []
    for i, o in enumerate(offsets):
        assert 0 <= o and o + win <= h
        rows = range(i * hs, (i + 1) * hs)
        kept += rows
        for r in rows:
            assert o <= max(r - radius, 0) and min(r + radius, h - 1) < o + win
    assert kept == list(range(h))


@pytest.mark.parametrize("h,n,radius", [(8, 2, 2), (12, 3, 2), (16, 4, 2), (18, 3, 3), (20, 5, 2), (24, 6, 2),
                                        (30, 5, 3), (32, 8, 2), (36, 6, 3), (48, 4, 6)])
@pytest.mark.parametrize("scale", [1, 3])
def test_build_windows_and_crop_concat_match_jax(h, n, radius, scale):
    """build_windows and crop_concat against JAX's on one seeded array; a
    per-pixel map of the windows (each pixel repeated scale x scale, as a
    model of that scale would place it) crops back to the full frame's."""
    x = np.random.default_rng(h * n + radius).random((1, h, 3, 2)).astype(np.float32)
    got = torch.stack(halo.build_windows(torch.from_numpy(x), n, radius))
    want = np.asarray(j_halo.build_windows(jnp.asarray(x), n, radius))
    np.testing.assert_array_equal(got.numpy(), want)
    y = np.repeat(np.repeat(want, scale, axis=2), scale, axis=3)
    cropped = halo.crop_concat(torch.from_numpy(y), h, n, radius, scale=scale).numpy()
    np.testing.assert_array_equal(cropped, np.asarray(j_halo.crop_concat(jnp.asarray(y), h, n, radius, scale=scale)))
    np.testing.assert_array_equal(cropped, np.repeat(np.repeat(x, scale, axis=1), scale, axis=2))


@pytest.mark.parametrize("h,n,radius", [(25, 2, 3), (10, 4, 1), (9, 2, 1), (24, 4, 4), (16, 4, 3), (12, 6, 2),
                                        (30, 3, 6), (12, 1, 9), (8, 8, 1), (20, 2, 4)])
def test_check_shardable_agrees_with_jax(h, n, radius):
    """Accepted by both or refused by both with the same message."""

    def outcome(check):
        try:
            check(h, n, radius)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(halo._check_shardable) == outcome(j_halo._check_shardable)


@pytest.mark.parametrize("blocks", [0, 1, 2, 4, 8, 16, 30])
def test_radii_match_jax(blocks):
    assert vsr_spatial.trunk_radius(blocks) == j_vsr_spatial.trunk_radius(blocks)
    for k in (3, 5, 7):
        assert halo.receptive_radius_wdsr(blocks, k) == j_halo.receptive_radius_wdsr(blocks, k)


@pytest.mark.parametrize("n,hloc,margin", [(1, 8, 3), (2, 8, 3), (2, 16, 9), (3, 6, 2), (4, 4, 4), (4, 12, 5),
                                           (8, 12, 11), (3, 10, 0)])
def test_row_mask_matches_jax(n, hloc, margin):
    """Each shard's window mask against JAX's, its shard index given by a
    named vmap axis as shard_map would."""
    want = np.asarray(jax.vmap(lambda _: j_vsr_spatial._row_mask(hloc, margin, n * hloc, "s"), axis_name="s")(
        jnp.arange(n)))
    for i in range(n):
        got = vsr_spatial._row_mask(i, hloc, margin, n * hloc, "cpu")
        np.testing.assert_array_equal(got.numpy().reshape(-1), want[i].reshape(-1))


@pytest.mark.parametrize("n,hloc,m", [(1, 5, 2), (2, 4, 1), (2, 6, 6), (3, 5, 2), (4, 3, 3), (5, 7, 4)])
def test_halo_exchange_is_the_zero_padded_frame(n, hloc, m):
    """Shard i's exchanged window is rows [i·hloc - m, (i+1)·hloc + m) of the
    whole frame with m zero rows beyond each edge: the neighbours' rows
    inside, the zeros of SAME padding outside."""
    full = torch.from_numpy(np.random.default_rng(n + hloc + m).random((2, n * hloc, 3, 4)).astype(np.float32))
    padded = torch.nn.functional.pad(full, (0, 0, 0, 0, m, m))
    got = vsr_spatial._halo_exchange(list(full.split(hloc, dim=1)), m)
    assert len(got) == n
    for i, g in enumerate(got):
        assert torch.equal(g, padded[:, i * hloc : (i + 1) * hloc + 2 * m])


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def item(self, i, rng):
        return np.full((1,), i, np.float32), np.full((1,), rng.random(), np.float32)


@pytest.mark.parametrize("items,batch,p,drop_last,shuffle,start", [
    (7, 2, 2, True, True, 0), (7, 2, 2, False, True, 0), (9, 2, 4, True, True, 0), (9, 3, 3, False, False, 0),
    (12, 2, 4, True, True, 1), (13, 4, 3, False, True, 1), (5, 1, 4, True, True, 2), (16, 4, 2, True, False, 1),
])
def test_per_process_batches_match_jax(monkeypatch, items, batch, p, drop_last, shuffle, start):
    """Every process's batches (its wrap-padded slice of the shared shuffle,
    resumed at ``start``) against the JAX package's with jax's process count
    and index patched alike; together the processes see every item."""
    seen = set()
    for r in range(p):
        for mod, count, index in ((isr, "process_count", "process_index"), (jax, "process_count", "process_index")):
            monkeypatch.setattr(mod, count, lambda: p)
            monkeypatch.setattr(mod, index, lambda r=r: r)
        got = list(isr.batch_iterator(_Items(items), batch, shuffle=shuffle, seed=5, drop_last=drop_last,
                                      start_batch=start, shard_by_process=True))
        want = list(j_isr._batches(_Items(items), batch, shuffle, 5, drop_last, shard_by_process=True,
                                   start_batch=start))
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        for a, _ in got:
            seen.update(a.ravel().astype(int).tolist())
    if not drop_last and start == 0:
        assert seen == set(range(items))


@pytest.mark.parametrize("items,batch,p", [(10, 2, 1), (10, 2, 2), (10, 2, 3), (10, 4, 3), (7, 8, 2), (1, 1, 4),
                                           (800, 16, 4), (801, 16, 4), (33, 4, 8), (64, 16, 3)])
def test_train_steps_per_epoch_matches_jax(monkeypatch, items, batch, p):
    monkeypatch.setattr(common_cli.distributed, "process_count", lambda: p)
    monkeypatch.setattr(jax, "process_count", lambda: p)
    assert common_cli.train_steps_per_epoch(items, batch) == j_common_cli.train_steps_per_epoch(items, batch)


@pytest.mark.parametrize("flags", [
    {}, {"distributed": False}, {"coordinator_address": "localhost:1"},
    {"coordinator_address": "localhost:1", "num_processes": 2},
    {"coordinator_address": "localhost:1", "process_id": 0},
])
def test_initialize_from_params_agrees_with_jax(flags):
    """Without a rendezvous flag both return False and join nothing; an
    explicit address without its size and rank is refused by both alike."""
    params = types.SimpleNamespace(**flags)

    def outcome(init):
        try:
            return init(params)
        except ValueError as e:
            return str(e)

    assert outcome(distributed.initialize_from_params) == outcome(j_distributed.initialize_from_params)
    assert not distributed.is_initialized()


@pytest.mark.parametrize("cards,own,spatial", [(1, 0, 1), (1, 0, 4), (2, 0, 2), (2, 1, 2), (4, 0, 4), (4, 3, 2),
                                               (4, 2, 8), (8, 5, 3)])
def test_mesh_places_shard_i_on_card_own_plus_i(monkeypatch, cards, own, spatial):
    """Shard i goes to the process's visible card (own + i) mod n, and so
    does data slot i of the n slots; the process's own card keeps the
    unsharded stages. The n // spatial data groups (at least one) put
    group g's shard i on card (own + g·spatial + i) mod n, its unsharded
    stages on its first card. No card is touched."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    m = mesh.Mesh(spatial, f"cuda:{own}")
    assert m.device == torch.device("cuda", own)
    assert m.devices == [torch.device("cuda", (own + i) % cards) for i in range(spatial)]
    assert m.data_devices == [torch.device("cuda", (own + i) % cards) for i in range(cards)]
    assert m.shape == {"data": 1, "spatial": spatial}
    assert len(m.groups) == max(cards // spatial, 1) and m.groups[0] is m
    for g, group in enumerate(m.groups):
        assert group.devices == [torch.device("cuda", (own + g * spatial + i) % cards) for i in range(spatial)]
        assert group.device == group.devices[0] and (g == 0 or group.groups == [group])


@pytest.mark.parametrize("cards,own,spatial,world", [(2, 0, 2, 2), (2, 1, 2, 2), (4, 0, 2, 4), (4, 3, 2, 4),
                                                     (4, 1, 4, 2), (8, 5, 3, 8)])
def test_mesh_keeps_every_shard_on_the_process_card_in_a_group(monkeypatch, cards, own, spatial, world):
    """In a process group each process owns one card: every one of its
    shards and its one data slot stay there, none on another rank's card.
    No card is touched."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    m = mesh.Mesh(spatial, f"cuda:{own}")
    assert m.device == torch.device("cuda", own)
    assert m.devices == [torch.device("cuda", own)] * spatial
    assert m.data_devices == [torch.device("cuda", own)]
    assert m.shape == {"data": world, "spatial": spatial}
    assert m.groups == [m]
