"""Host transfers of complex device pytrees (checkpoints, artifacts) and
parallel.distributed helpers."""

import jax
import jax.numpy as jnp
import numpy as np

from radar_slam_tpu.io import artifacts
from radar_slam_tpu.parallel import distributed
from radar_slam_tpu.utils.checkpointing import load_pytree, save_pytree


@jax.jit
def _make():
    return {"c": (jnp.arange(6, dtype=jnp.float32)
                  + 1j * jnp.ones(6)).astype(jnp.complex64),
            "f": jnp.ones((2, 3)),
            "i": jnp.arange(4, dtype=jnp.int32)}


def test_device_get_complex_and_pytree(tmp_path):
    """A jitted complex/float/int pytree survives a checkpoint round trip
    with values, dtypes and structure intact."""
    tree = _make()
    path = save_pytree(tmp_path / "state_0001", tree, step=7)
    restored, step = load_pytree(path, tree)
    assert step == 7
    assert restored["c"].dtype == jnp.complex64
    np.testing.assert_allclose(np.asarray(restored["c"]).real, np.arange(6))
    np.testing.assert_allclose(np.asarray(restored["c"]).imag, 1.0)
    assert restored["f"].shape == (2, 3)
    assert restored["i"].dtype == jnp.int32


def test_device_get_passthrough_numpy(tmp_path):
    """Artifact writers take host numpy and device complex arrays alike."""
    host = np.ones((2, 3), np.complex64)
    artifacts.save_raw_frame(tmp_path, 0, host)
    artifacts.save_raw_frame(tmp_path, 1, _make()["c"])
    np.testing.assert_array_equal(artifacts.load_raw_frame(tmp_path, 0),
                                  host)
    np.testing.assert_allclose(artifacts.load_raw_frame(tmp_path, 1),
                               np.arange(6) + 1j)


def test_distributed_topology_single_process():
    info = distributed.initialize()
    assert info["process_count"] == 1
    assert info["global_devices"] >= 1
    assert not distributed.is_multihost()
