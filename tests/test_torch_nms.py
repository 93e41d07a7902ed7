"""The port's greedy NMS against the JAX package's, exactly.

Random circles sorted best first (some masked invalid) go through
``magnify_tpu.ops.nms.parallel_greedy_nms`` (its raster rounds on the CPU),
the sequential oracle ``claimed_raster_nms``, and the port's raster rounds;
the accepted masks must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnify_tpu.ops import nms as jnms
from magnify_tpu_torch.ops import nms as tnms


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _circles(seed, n, h, w, max_radius):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-max_radius, h + max_radius, n)
    cols = rng.integers(-max_radius, w + max_radius, n)
    rads = rng.integers(max(1, max_radius - 4), max_radius + 1, n)
    circles = np.stack([rows, cols, rads], axis=1).astype(np.int32)
    valid = rng.random(n) > 0.1
    return circles, valid


@pytest.mark.parametrize("seed,n,min_dist", [(0, 64, 5), (1, 300, 8),
                                             (2, 1000, 4), (3, 1, 6)])
def test_greedy_nms_matches(seed, n, min_dist):
    h, w, max_radius = 120, 150, 12
    circles, valid = _circles(seed, n, h, w, max_radius)
    kw = dict(min_dist=min_dist, height=h, width=w, max_radius=max_radius)
    par = np.asarray(jnms.parallel_greedy_nms(jnp.asarray(circles),
                                              jnp.asarray(valid), **kw))
    seq = np.asarray(jnms.claimed_raster_nms(jnp.asarray(circles),
                                             jnp.asarray(valid), **kw))
    got = tnms.parallel_greedy_nms(torch.as_tensor(circles),
                                   torch.as_tensor(valid), **kw).numpy()
    np.testing.assert_array_equal(par, got)
    np.testing.assert_array_equal(seq, got)
    assert not (got & ~valid).any()


def test_greedy_nms_edge_cases():
    kw = dict(height=50, width=50, max_radius=6)
    empty = torch.zeros((0, 3), dtype=torch.int32)
    none = torch.zeros((0,), dtype=torch.bool)
    assert tnms.parallel_greedy_nms(empty, none, min_dist=4, **kw).shape == (0,)
    circles, valid = _circles(5, 20, 50, 50, 6)
    v = torch.as_tensor(valid)
    assert torch.equal(tnms.parallel_greedy_nms(torch.as_tensor(circles), v,
                                                min_dist=0, **kw), v)
