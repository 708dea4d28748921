"""The port's multi-process mesh on the CPU, the counterpart of
``tests/test_multihost.py``: two OS processes, four CPU shards each,
``TPUCLIP_MULTIHOST=1`` with tpuclip's coordinator variables through
``maybe_distributed_init`` (gloo), one mesh of eight global shards.

Each worker runs the sharded int8 search with the exact rescore (the
cross-process all_gather merge), three data-parallel train steps (the
features gathered across the processes, the gradients summed over them)
and three data x model steps on a mesh of ``["cpu"] * 4`` at
``model_parallelism=2`` (two tensor-parallel replicas a process).
This process runs the same seeded inputs through tpuclip's functions on
its 8-device virtual CPU mesh: the ids must be identical, the scores
within 1e-6, the first loss within 1e-5 relative and the three losses
within 1e-4 (and falling), for the data x model steps against tpuclip's
4 x 2 mesh too. The workers have a timeout of their own."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT_S = 240

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["TPUCLIP_MULTIHOST"] = "1"
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = str(pid)
    import numpy as np, torch
    import torch.distributed as dist
    from tpuclip_torch.parallel.mesh import DATA_AXIS, make_mesh, maybe_distributed_init
    maybe_distributed_init(backend="gloo", timeout_s=120)
    assert dist.get_world_size() == 2, dist.get_world_size()
    from tpuclip_torch.ops.topk_int8 import quantize_matrix
    from tpuclip_torch.parallel.sharded_search import pad_for_mesh, shard_matrix, sharded_topk_int8_rerank

    mesh = make_mesh(["cpu"] * 4)
    assert mesh.shape[DATA_AXIS] == 8 and mesh.rank == pid, mesh
    rng = np.random.default_rng(0)
    N, D, k = 4096, 64, 5
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    padded, n_valid = pad_for_mesh(rows, mesh, 2048)
    m8, scales = quantize_matrix(padded, len(padded), "cpu")
    queries = rng.standard_normal((2, D)).astype(np.float32)
    scores, ridx = sharded_topk_int8_rerank(
        torch.from_numpy(queries), shard_matrix(m8, mesh), shard_matrix(scales, mesh),
        shard_matrix(padded, mesh), k, mesh, n_valid)

    from tpuclip_torch.models import configs
    from tpuclip_torch.models.siglip import build_model
    from tpuclip_torch.parallel import training

    cfg = configs.get_config("tpuclip/test-tiny")
    model = build_model(cfg, torch.device("cpu"), torch.float32)
    sd = dict(np.load(os.path.join(os.path.dirname(out), "params.npz")))
    model.load_state_dict({name: torch.from_numpy(v) for name, v in sd.items()}, strict=True)
    opt = training.make_optimizer(learning_rate=1e-3)
    state = training.init_train_state(model, opt, mesh=mesh)
    step = training.make_train_step(opt, compute_dtype=torch.float32, mesh=mesh)
    batch = np.load(os.path.join(os.path.dirname(out), "batch.npz"))
    images, ids = torch.from_numpy(batch["images"]), torch.from_numpy(batch["ids"])
    mask = torch.ones_like(ids)
    losses = []
    for _ in range(3):
        state, loss = step(state, images, ids, mask)
        losses.append(float(loss))
    probe = state.model.get_parameter("text.head.weight").detach().numpy()

    # Data x model: 2 data rows x 2 model ranks a process, 4 global rows.
    # Many small ops a rank: one intra-op thread keeps the two workers (and
    # any other test workers on the host) from contending.
    torch.set_num_threads(1)
    tp_mesh = make_mesh(["cpu"] * 4, model_parallelism=2)
    assert tp_mesh.shape == {"data": 4, "model": 2}, tp_mesh
    tp_model = build_model(cfg, torch.device("cpu"), torch.float32)
    tp_model.load_state_dict({name: torch.from_numpy(v) for name, v in sd.items()}, strict=True)
    tp_opt = training.make_optimizer(learning_rate=1e-3)
    tp_state = training.init_train_state(tp_model, tp_opt, mesh=tp_mesh)
    tp_step = training.make_train_step(tp_opt, compute_dtype=torch.float32, mesh=tp_mesh)
    tp_losses = []
    for _ in range(3):
        tp_state, loss = tp_step(tp_state, images, ids, mask)
        tp_losses.append(float(loss))
    fc1 = tp_state.model.get_parameter("text.encoder.layers.0.mlp.shards.1.fc1.weight").detach().numpy()
    with open(out, "w") as f:
        json.dump({"scores": scores.numpy().tolist(), "rows": ridx.numpy().tolist(), "losses": losses,
                   "head_sum": float(np.float64(probe).sum()), "tp_losses": tp_losses,
                   "tp_fc1_sum": float(np.float64(fc1).sum())}, f)
    dist.destroy_process_group()
    print(f"MULTIHOST-OK {pid}", flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_sharded_search_and_train(tmp_path):
    from tpuclip.models import get_config, init_params
    from tpuclip.ops.topk import pad_matrix_t
    from tpuclip.ops.topk_int8 import quantize_matrix_t
    from tpuclip.parallel import make_mesh, shard_params
    from tpuclip.parallel.mesh import DATA_AXIS
    from tpuclip.parallel.sharded_search import shard_matrix, sharded_topk_int8_rerank
    from tpuclip.parallel.training import init_train_state, make_optimizer, make_train_step
    from tpuclip_torch.models.convert import jax_params_to_state_dict

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(0), cfg)
    np.savez(tmp_path / "params.npz", **{
        k: np.asarray(v, np.float32) for k, v in jax_params_to_state_dict(jax.tree.map(np.asarray, params)).items()})
    rng2 = np.random.default_rng(4)
    images = rng2.integers(0, 256, size=(16, cfg.vision.image_size, cfg.vision.image_size, 3), dtype=np.uint8)
    ids = rng2.integers(0, cfg.text.vocab_size, size=(16, 64)).astype(np.int32)
    np.savez(tmp_path / "batch.npz", images=images, ids=ids)

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TPUCLIP_MULTIHOST")}
    env["PYTHONPATH"] = REPO
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(port), str(outs[i])],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log)
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {i} rc={p.returncode}\n{log[-3000:]}"
        assert f"MULTIHOST-OK {i}" in log, log[-3000:]
    results = [json.loads(o.read_text()) for o in outs]

    # tpuclip on its 8-device mesh, the same inputs.
    mesh = make_mesh()
    ndev = mesh.shape[DATA_AXIS]
    rng = np.random.default_rng(0)
    N, D, k = 4096, 64, 5
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mt, n_valid = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=2048 * ndev)
    q8, scales = quantize_matrix_t(mt)
    queries = rng.standard_normal((2, D)).astype(np.float32)
    want_s, want_i = sharded_topk_int8_rerank(
        jnp.asarray(queries), shard_matrix(jnp.asarray(q8), mesh),
        jax.device_put(jnp.asarray(scales), NamedSharding(mesh, P(DATA_AXIS))),
        jax.device_put(jnp.asarray(np.pad(rows, ((0, mt.shape[1] - N), (0, 0)))),
                       NamedSharding(mesh, P(DATA_AXIS, None))),
        k, mesh, jnp.asarray(n_valid, jnp.int32))
    exact = queries @ rows.T
    for r in results:
        np.testing.assert_array_equal(np.asarray(r["rows"]), np.asarray(want_i))
        np.testing.assert_allclose(np.asarray(r["scores"]), np.asarray(want_s), rtol=0, atol=1e-6)
        for qi in range(2):
            assert r["rows"][qi] == list(np.lexsort((np.arange(N), -exact[qi]))[:k])

    opt = make_optimizer(learning_rate=1e-3)
    state = init_train_state(shard_params(params, mesh), opt)
    step = make_train_step(cfg, opt, mesh=mesh, compute_dtype=jnp.float32)
    want = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(ids))
        want.append(float(loss))
    for r in results:
        assert abs(r["losses"][0] - want[0]) <= 1e-5 * abs(want[0]), (r["losses"], want)
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=1e-4)
        assert r["losses"][-1] < r["losses"][0]
    # Both processes hold the same parameters after the steps.
    assert results[0]["head_sum"] == results[1]["head_sum"]

    # Three data x model steps on tpuclip's 4 x 2 mesh (fresh parameters:
    # the steps above donated theirs).
    tp_mesh = make_mesh(model_parallelism=2)
    state = init_train_state(shard_params(init_params(jax.random.PRNGKey(0), cfg), tp_mesh), opt)
    step = make_train_step(cfg, opt, mesh=tp_mesh, compute_dtype=jnp.float32)
    want = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(ids))
        want.append(float(loss))
    for r in results:
        assert abs(r["tp_losses"][0] - want[0]) <= 1e-5 * abs(want[0]), (r["tp_losses"], want)
        np.testing.assert_allclose(r["tp_losses"], want, rtol=0, atol=1e-4)
        assert r["tp_losses"][-1] < r["tp_losses"][0]
    assert results[0]["tp_fc1_sum"] == results[1]["tp_fc1_sum"]
