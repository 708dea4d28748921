"""The port's tensor-parallel towers (``tpuclip_torch/parallel/tensor_parallel.py``)
and its data x model train step against tpuclip's, on the CPU.

tpuclip runs ``shard_params`` on the conftest's 8-device virtual CPU mesh
at ``model_parallelism`` 2 (4 x 2) and 4 (2 x 4); the port runs
``shard_params`` on ``make_mesh(["cpu"] * 8, model_parallelism=...)``,
one tensor-parallel replica per data row, each on its rows of the batch.
Parameters come from tpuclip's ``init_params`` (``load_jax_params``),
inputs from numpy seeds, all in fp32. Agreement: image, masked text and
NaFlex features within rtol 1e-4, atol 1e-5 of tpuclip's tensor-parallel
output and of the port's one-device output (tpuclip's own bar,
``tests/test_parallel.py``); the AdamW step's first loss within 1e-5
relative of tpuclip's and five losses within 1e-4; gradients within 1e-5
of each leaf's largest against the port's one-device gradients; Adafactor
losses within 1e-5 relative of the port's one-device step, on a widened
preset whose shards change ``_factored_dims`` (mp = 2 and 4); the
checkpoint round trip bit-equal.

Placement is held by :class:`Placement`: a mesh of ``cpu:0`` ... ``cpu:7``
(a CPU build ignores the index), a torch function mode that tags each
tensor's storage with the device it was made on or copied to, reports
that tag as the tensor's ``device``, and records every operation other
than an explicit copy that takes tensors of two devices, as a second card
would refuse it."""

import copy
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

import tpuclip.parallel.training as jx_train
import tpuclip_torch.parallel.training as pt_train
from tpuclip.models import get_config, init_params
from tpuclip.parallel import make_mesh as jx_make_mesh
from tpuclip.parallel import shard_params as jx_shard_params
from tpuclip_torch.models import configs as pt_configs
from tpuclip_torch.models.convert import load_jax_params
from tpuclip_torch.models.siglip import build_model, init_params_
from tpuclip_torch.parallel import make_mesh, param_shardings, shard_layout, shard_params
from tpuclip_torch.parallel.checkpoint import TrainStateError, restore_train_state, save_train_state
from tpuclip_torch.parallel.mesh import MODEL_AXIS, Mesh
from tpuclip_torch.parallel.tensor_parallel import gather_logical, to_tensor_parallel

MODEL = "tpuclip/test-tiny"
NAFLEX = "tpuclip/test-tiny-naflex"
MPS = [2, 4]


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The split towers run many small ops a rank; with several test
    workers on the host, torch's intra-op threads would only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config(MODEL)
    return cfg, jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_model(params, name=MODEL):
    model = build_model(pt_configs.get_config(name), torch.device("cpu"), torch.float32)
    return load_jax_params(model, params)


def _jx_tp(params, mp):
    return jx_shard_params(jax.tree.map(jnp.asarray, params), jx_make_mesh(model_parallelism=mp))


def _per_row(replicas, fn, *arrays):
    """Each replica's features of its rows of the batch, concatenated."""
    b = len(arrays[0]) // len(replicas)
    return np.concatenate([fn(r, *(_t(a[j * b : (j + 1) * b]) for a in arrays)).numpy()
                           for j, r in enumerate(replicas)])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _ragged_mask(rng, b, s):
    return (np.arange(s)[None, :] < rng.integers(3, s + 1, (b, 1))).astype(np.int32)


# ===================================================== the forward passes


@pytest.mark.parametrize("mp", MPS)
def test_tp_image_features_match_tpuclip(tiny, mp):
    """A batch of 8 over 8 / mp tensor-parallel replicas against tpuclip's
    ``shard_params``'d forward and the port's one-device forward; unit norm."""
    from tpuclip.models.siglip import get_image_features

    cfg, params = tiny
    batch = np.random.default_rng(3).integers(0, 256, size=(8, 56, 56, 3), dtype=np.uint8)
    want = np.asarray(get_image_features(_jx_tp(params, mp), jnp.asarray(batch), cfg))
    model = _port_model(params)
    replicas = shard_params(model, make_mesh(["cpu"] * 8, model_parallelism=mp))
    assert len(replicas) == 8 // mp
    got = _per_row(replicas, lambda r, x: r.get_image_features(x), batch)
    _close(got, want)
    _close(got, model.get_image_features(_t(batch)).numpy())
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mp", MPS)
def test_tp_masked_text_features_match_tpuclip(tiny, mp):
    """Ragged attention masks (3 to 64 kept tokens) through the split text
    tower, against tpuclip's masked ``get_text_features``."""
    from tpuclip.models.siglip import get_text_features

    cfg, params = tiny
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.text.vocab_size, size=(8, 64)).astype(np.int32)
    mask = _ragged_mask(rng, 8, 64)
    want = np.asarray(get_text_features(_jx_tp(params, mp), jnp.asarray(ids), cfg,
                                        attention_mask=jnp.asarray(mask)))
    model = _port_model(params)
    replicas = shard_params(model, make_mesh(["cpu"] * 8, model_parallelism=mp))
    got = _per_row(replicas, lambda r, i, m: r.get_text_features(i, m), ids, mask)
    _close(got, want)
    _close(got, model.get_text_features(_t(ids), _t(mask)).numpy())
    # The mask is live: unmasked features differ.
    assert np.abs(got - model.get_text_features(_t(ids)).numpy()).max() > 1e-3


@pytest.mark.parametrize("mp", MPS)
def test_tp_naflex_features_match_tpuclip(mp):
    """NaFlex at mixed aspects (grids 1-8 x 1-8 of 64 slots): the key mask
    broadcast over each rank's heads, the split MAP head."""
    from tpuclip.models.naflex import get_image_features_naflex

    cfg = get_config(NAFLEX)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(4)
    b, L = 8, cfg.vision.max_num_patches
    patches = rng.integers(0, 256, size=(b, L, cfg.vision.patch_size**2 * 3), dtype=np.uint8)
    masks = np.ones((b, L), np.int32)
    shapes = np.empty((b, 2), np.int32)
    for i in range(b):
        h = int(rng.integers(1, 9))
        w = min(L // h, int(rng.integers(1, 9)))
        shapes[i] = (h, w)
        masks[i, h * w :] = 0
    want = np.asarray(get_image_features_naflex(
        _jx_tp(params, mp), jnp.asarray(patches), jnp.asarray(masks), jnp.asarray(shapes), cfg))
    model = _port_model(params, NAFLEX)
    replicas = shard_params(model, make_mesh(["cpu"] * 8, model_parallelism=mp))
    got = _per_row(replicas, lambda r, p, m, s: r.get_image_features_naflex(p, m, s), patches, masks, shapes)
    _close(got, want)
    _close(got, model.get_image_features_naflex(_t(patches), _t(masks), _t(shapes)).numpy())


def test_tp_layout_follows_param_shardings(tiny):
    """Every shard maps back to a parameter of the one-device model, split
    along the dim ``param_shardings`` gives it; the gathered shards equal
    the source bit for bit; the source model is left where it was."""
    _, params = tiny
    model = _port_model(params)
    mesh = make_mesh(["cpu"] * 8, model_parallelism=2)
    specs = param_shardings(model, mesh)
    replica = to_tensor_parallel(model, mesh.devices[:2])
    layout = shard_layout(replica)
    source = dict(model.named_parameters())
    assert {s.logical for s in layout.values()} == set(source)
    for name, shard in layout.items():
        spec = specs[shard.logical]
        assert shard.dim == (spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None), name
        assert (shard.ranks == 2) == (shard.dim is not None), name
    # 10 split a layer and in the vision head, two ranks each.
    n_split = sum(s.dim is not None for s in layout.values())
    assert n_split == 2 * 10 * (2 + 2 + 1)
    gathered = gather_logical(dict(replica.named_parameters()), layout)
    for name, p in source.items():
        assert torch.equal(gathered[name], p), name
    assert sum(p.numel() for p in replica.parameters()) == sum(p.numel() for p in source.values())


def test_tp_refuses_a_model_axis_that_does_not_divide_the_heads(tiny):
    _, params = tiny
    model = _port_model(params)
    with pytest.raises(ValueError, match="num_heads=4"):
        shard_params(model, make_mesh(["cpu"] * 8, model_parallelism=8))
    with pytest.raises(ValueError, match="num_heads=4"):
        shard_params(model, make_mesh(["cpu"] * 6, model_parallelism=3))
    wide = dataclasses.replace(pt_configs.get_config(MODEL), text=dataclasses.replace(
        pt_configs.get_config(MODEL).text, intermediate_size=130))
    with pytest.raises(ValueError, match="intermediate_size=130"):
        to_tensor_parallel(build_model(wide, torch.device("cpu"), torch.float32), ["cpu"] * 4)


# ========================================================== the train step


def _batch(cfg, seed, b=16):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(b, cfg.vision.image_size, cfg.vision.image_size, 3), dtype=np.uint8)
    ids = rng.integers(0, cfg.text.vocab_size, size=(b, cfg.text.max_length)).astype(np.int32)
    return images, ids, _ragged_mask(rng, b, cfg.text.max_length)


@pytest.mark.parametrize("mp", MPS)
def test_tp_train_step_matches_tpuclip(tiny, mp):
    """tpuclip's ``make_train_step`` on its (8 / mp) x mp mesh against the
    port's data x model step on 8 CPU devices: AdamW at lr 1e-3, five steps
    on one batch of 16 with an all-ones mask (tpuclip's step embeds
    unmasked). Every row's replica holds the lead row's shards after."""
    cfg, params = tiny
    images, ids, _ = _batch(cfg, 4)
    opt = jx_train.make_optimizer(learning_rate=1e-3)
    mesh = jx_make_mesh(model_parallelism=mp)
    state = jx_train.init_train_state(jx_shard_params(jax.tree.map(jnp.asarray, params), mesh), opt)
    step = jx_train.make_train_step(cfg, opt, mesh=mesh, compute_dtype=jnp.float32)
    want = []
    for _ in range(5):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(ids))
        want.append(float(loss))

    pmesh = make_mesh(["cpu"] * 8, model_parallelism=mp)
    popt = pt_train.make_optimizer(learning_rate=1e-3)
    pstate = pt_train.init_train_state(_port_model(params), popt, mesh=pmesh)
    pstep = pt_train.make_train_step(popt, compute_dtype=torch.float32, mesh=pmesh)
    got = []
    for _ in range(5):
        pstate, loss = pstep(pstate, _t(images), _t(ids), torch.ones(16, 64, dtype=torch.int32))
        got.append(float(loss))
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0] and pstate.step == 5
    lead = dict(pstate.model.named_parameters())
    for replica in pstate.replicas[1:]:
        for name, p in replica.named_parameters():
            assert torch.equal(p, lead[name]), name


@pytest.mark.parametrize("mp", MPS)
def test_tp_grads_equal_single_device(tiny, mp):
    """The data x model gradients, gathered into logical tensors, against
    the port's one-device gradients on one masked batch: within 1e-5 of
    each leaf's largest (a floor of 1e-7 for the attention key biases,
    whose gradients are zero but for rounding)."""
    cfg, params = tiny
    images, ids, mask = (_t(a) for a in _batch(cfg, 6))
    single = _port_model(params).requires_grad_(True)
    loss = pt_train.sigmoid_contrastive_loss(single, images, ids, torch.float32, mask)
    loss.backward()
    mesh = make_mesh(["cpu"] * 8, model_parallelism=mp)
    state = pt_train.init_train_state(_port_model(params), pt_train.make_optimizer(), mesh=mesh)
    tp_loss, grads = pt_train.data_parallel_value_and_grad(state, mesh, images, ids, mask, torch.float32)
    assert abs(tp_loss.item() - loss.item()) <= 1e-6 * abs(loss.item())
    layout = state.layout
    logical = gather_logical(grads, layout)
    assert set(logical) == {n for n, _ in single.named_parameters()}
    for name, p in single.named_parameters():
        tol = max(1e-5 * float(p.grad.abs().max()), 1e-7)
        np.testing.assert_allclose(logical[name].numpy(), p.grad.numpy(), rtol=0, atol=tol, err_msg=name)


def _wide_config():
    """test-tiny at 128 wide with a 256-wide MLP (4 heads): fc1 is (256, 128),
    factored over (1, 0); its shard is (128, 128) at mp = 2, a tie that
    factors over (0, 1), and (64, 128) at mp = 4, which is not factored."""
    cfg = pt_configs.get_config(MODEL)
    vision = dataclasses.replace(cfg.vision, hidden_size=128, intermediate_size=256)
    text = dataclasses.replace(cfg.text, hidden_size=128, intermediate_size=256, projection_size=128)
    return dataclasses.replace(cfg, vision=vision, text=text)


@pytest.mark.parametrize("mp", MPS)
def test_tp_adafactor_matches_single_device(mp):
    """Six Adafactor steps at lr 1e-3 on one masked batch of 16: the data x
    model step's losses within 1e-5 relative of the one-device step's, and
    its parameters, gathered, within 1e-4 of each leaf's largest update
    (Adafactor divides each gradient by its own RMS, so rounding in small
    gradients grows over the steps) plus one fp32 rounding of the leaf's
    largest value (``p + u``). The
    attention key biases are left out of that: their gradients are zero
    but for rounding, and Adafactor scales that noise to full-size steps."""
    cfg = _wide_config()
    base = init_params_(build_model(cfg, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(7))
    images, ids, mask = (_t(a) for a in _batch(cfg, 8))
    mesh = make_mesh(["cpu"] * 8, model_parallelism=mp)
    assert pt_train._factored_dims((256, 128)) == (1, 0)
    assert pt_train._factored_dims((256 // mp, 128)) != (1, 0)

    def run(state, step):
        losses = []
        for _ in range(6):
            state, loss = step(state, images, ids, mask)
            losses.append(float(loss))
        return state, losses

    one_opt = pt_train.make_optimizer(learning_rate=1e-3, factored=True)
    one, want = run(pt_train.init_train_state(copy.deepcopy(base), one_opt),
                    pt_train.make_train_step(one_opt, compute_dtype=torch.float32))
    tp_opt = pt_train.make_optimizer(learning_rate=1e-3, factored=True)
    tp, got = run(pt_train.init_train_state(copy.deepcopy(base), tp_opt, mesh=mesh),
                  pt_train.make_train_step(tp_opt, compute_dtype=torch.float32, mesh=mesh))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    layout = tp.layout
    fc1 = "vision.encoder.layers.0.mlp.shards.0.fc1.weight"
    assert fc1 in tp.opt_state["v_row"] and tp.opt_state["v_row"][fc1].shape == (128,)
    assert tp.opt_state["v_col"][fc1].shape == (256 // mp,)
    logical = gather_logical(dict(tp.model.named_parameters()), layout)
    for name, p in one.model.named_parameters():
        if name.endswith("attn.k.bias"):
            continue
        p = p.detach()
        moved = float((p - base.get_parameter(name)).abs().max())
        ulp = float(np.spacing(np.float32(p.abs().max())))
        np.testing.assert_allclose(logical[name].detach().numpy(), p.numpy(), rtol=0,
                                   atol=1e-4 * moved + ulp, err_msg=name)


@pytest.mark.parametrize("factored", [False, True], ids=["adamw", "adafactor"])
def test_tp_checkpoint_round_trip(tiny, tmp_path, factored):
    """A data x model state after two steps, saved, restored into a
    one-device template, saved again and restored into a fresh
    tensor-parallel template: every parameter and optimizer tensor
    bit-equal to the original's, and the step count kept. A state of the
    other optimizer is refused."""
    cfg = _wide_config() if factored else pt_configs.get_config(MODEL)
    base = init_params_(build_model(cfg, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(9))
    images, ids, mask = (_t(a) for a in _batch(cfg, 10, b=8))
    mesh = make_mesh(["cpu"] * 8, model_parallelism=2)
    opt = pt_train.make_optimizer(learning_rate=1e-3, factored=factored)
    state = pt_train.init_train_state(base, opt, mesh=mesh)
    step = pt_train.make_train_step(opt, compute_dtype=torch.float32, mesh=mesh)
    for _ in range(2):
        state, _ = step(state, images, ids, mask)
    save_train_state(str(tmp_path / "tp"), state)

    fresh = init_params_(build_model(cfg, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(1))
    one = restore_train_state(str(tmp_path / "tp"), pt_train.init_train_state(fresh, opt))
    assert one.step == 2 and all(s.dim is None for s in one.layout.values())
    save_train_state(str(tmp_path / "one"), one)
    fresh = init_params_(build_model(cfg, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(2))
    again = restore_train_state(str(tmp_path / "one"), pt_train.init_train_state(fresh, opt, mesh=mesh))
    assert again.step == 2
    for name, p in state.model.named_parameters():
        assert torch.equal(again.model.get_parameter(name), p), name
    for part, tree in state.opt_state.items():
        if isinstance(tree, dict):
            assert set(again.opt_state[part]) == set(tree), part
            for name, t in tree.items():
                assert torch.equal(again.opt_state[part][name], t), (part, name)
        else:
            assert again.opt_state[part] == tree
    for replica in again.replicas[1:]:
        for name, p in replica.named_parameters():
            assert torch.equal(p, again.model.get_parameter(name)), name
    other = pt_train.make_optimizer(learning_rate=1e-3, factored=not factored)
    with pytest.raises(TrainStateError, match="another optimizer"):
        restore_train_state(str(tmp_path / "tp"), pt_train.init_train_state(fresh, other, mesh=mesh))


# ============================================================== placement


class Placement(TorchFunctionMode):
    """CPU code run as if each tensor lay on its own device. A tensor's
    storage is tagged with the indexed device (``cpu:k``) it was made on or
    copied to; ``Tensor.device`` reports the tag (a gradient takes its
    parameter's, as autograd places it); an explicit copy (``to``,
    ``cpu``, ``copy_``) to another device makes a new storage. Any other
    operation whose tensors carry two tags, or a tag and a host tensor of
    more than zero dims, is recorded in ``mixed``."""

    _MOVES = ("to", "cpu")
    # Operations that read only the shape or type of their other tensors.
    _SHAPE_OF_OTHER = ("view_as", "expand_as", "reshape_as", "_has_compatible_shallow_copy_type")

    def __init__(self):
        super().__init__()
        self.where = {}
        self.mixed = []

    def tag(self, t):
        ptr = t.untyped_storage().data_ptr()
        return self.where.get(ptr) if ptr else None

    def put(self, t, dev):
        ptr = t.untyped_storage().data_ptr()
        if not ptr:
            return
        if dev is None or dev.index is None:
            self.where.pop(ptr, None)
        else:
            self.where[ptr] = dev

    def _target(self, name, src, args, kwargs):
        if name == "cpu":
            return None
        rest = args[1:]
        if rest and isinstance(rest[0], torch.Tensor):
            return self.tag(rest[0])
        dev = torch._C._nn._parse_to(*rest, **{k: v for k, v in kwargs.items() if k != "copy"})[0]
        return src if dev is None else (dev if dev.index is not None else None)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        owner = getattr(func, "__self__", None)
        if name == "__get__" and owner is torch.Tensor.device:
            return self.tag(args[0]) or func(*args)
        if name == "__get__" and owner is torch.Tensor.grad:
            g = func(*args)
            if g is not None:
                self.put(g, self.tag(args[0]))
            return g
        if name in ("__get__", "__set__") or name in self._SHAPE_OF_OTHER:
            return func(*args, **kwargs)
        tensors = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        if name in self._MOVES and args and isinstance(args[0], torch.Tensor):
            src = self.tag(args[0])
            target = self._target(name, src, args, kwargs)
            out = func(*args, **kwargs)
            if target != src and out.untyped_storage().data_ptr() == args[0].untyped_storage().data_ptr():
                out = out.clone()
            self.put(out, target)
            return out
        if name == "copy_":
            return func(*args, **kwargs)
        tags = {self.tag(t) for t in tensors if t.dim() > 0 or self.tag(t) is not None}
        if len(tags) > 1:
            self.mixed.append((name, sorted(map(str, tags))))
        dev = kwargs.get("device")
        if dev is not None:
            dev = torch.device(dev)
            target = dev if dev.index is not None else None
        else:
            target = next(iter(tags - {None}), None)
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.put(t, target)
        return out


def _indexed_mesh(mp, n=8, group=None):
    return Mesh([torch.device("cpu", k) for k in range(n)], model_parallelism=mp, group=group)


def test_placement_recorder_sees_a_mix():
    """The recorder itself: a sum over two devices' tensors is recorded, a
    copy to the other device first is not."""
    rec = Placement()
    with rec:
        a = torch.ones(3).to("cpu:0")
        b = torch.ones(3).to("cpu:1")
        assert a.device == torch.device("cpu", 0) and b.device == torch.device("cpu", 1)
        _ = a + b.to(a.device)
        assert not rec.mixed
        _ = sum((t * t).sum() for t in (a, b))
    assert rec.mixed and rec.mixed[0][1] == ["cpu:0", "cpu:1"]


def _expect_on(mesh, state):
    """Each parameter name of ``state``'s lead replica → the device of its
    rank in row j, per replica j."""
    mp = mesh.model_parallelism
    return [{n: mesh.devices[j * mp + s.rank] for n, s in state.layout.items()}
            for j in range(len(state.replicas))]


@pytest.mark.parametrize("mp,factored", [(2, False), (2, True), (4, True)])
def test_tp_placement(tiny, mp, factored):
    """On a mesh of cpu:0 ... cpu:7: every shard's parameters on
    ``mesh.devices[j * mp + rank]``, the replicated ones on the row's first;
    after a data x model step, each gradient and each optimizer tensor on
    its parameter's device; the features on the row's first device; and no
    operation but an explicit copy takes tensors of two devices."""
    cfg = _wide_config() if factored else get_config(MODEL)
    if factored:
        model = init_params_(build_model(cfg, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(3))
    else:
        model = _port_model(tiny[1])
    images, ids, mask = (_t(a) for a in _batch(cfg, 11, b=8))
    mesh = _indexed_mesh(mp)
    opt = pt_train.make_optimizer(learning_rate=1e-3, factored=factored)
    rec = Placement()
    with rec:
        state = pt_train.init_train_state(model, opt, mesh=mesh)
        expect = _expect_on(mesh, state)
        for j, replica in enumerate(state.replicas):
            for name, p in replica.named_parameters():
                assert p.device == expect[j][name], (j, name, p.device)
        _, grads = pt_train.data_parallel_value_and_grad(state, mesh, images, ids, mask, torch.float32)
        for name, g in grads.items():
            assert g.device == expect[0][name], (name, g.device)
        step = pt_train.make_train_step(opt, compute_dtype=torch.float32, mesh=mesh)
        state, loss = step(state, images, ids, mask)
        for part, tree in state.opt_state.items():
            for name, t in (tree.items() if isinstance(tree, dict) else ()):
                assert t.device == expect[0][name], (part, name, t.device)
        for j, replica in enumerate(state.replicas):
            for name, p in replica.named_parameters():
                assert p.device == expect[j][name], (j, name, p.device)
            with torch.no_grad():
                feats = replica.get_image_features(images[:2].to(mesh.devices[j * mp]))
                txt = replica.get_text_features(ids[:2].to(mesh.devices[j * mp]), mask[:2].to(mesh.devices[j * mp]))
            assert feats.device == txt.device == mesh.devices[j * mp]
    assert not rec.mixed, rec.mixed[:10]
    assert np.isfinite(float(loss))


def test_tp_naflex_placement():
    """The NaFlex tower split over cpu:0 ... cpu:3: its fp32 key mask goes
    to each rank's device with that rank's heads, with no mix."""
    cfg = pt_configs.get_config(NAFLEX)
    model = init_params_(build_model(cfg, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    L = cfg.vision.max_num_patches
    patches = _t(rng.integers(0, 256, size=(2, L, cfg.vision.patch_size**2 * 3), dtype=np.uint8))
    masks = _t((np.arange(L)[None] < np.array([[12], [40]])).astype(np.int32))
    shapes = _t(np.array([[3, 4], [5, 8]], np.int32))
    want = model.get_image_features_naflex(patches, masks, shapes)
    rec = Placement()
    with rec:
        devices = [torch.device("cpu", k) for k in range(4)]
        replica = to_tensor_parallel(model, devices)
        got = replica.get_image_features_naflex(*(x.to(devices[0]) for x in (patches, masks, shapes)))
        assert got.device == devices[0]
    assert not rec.mixed, rec.mixed[:10]
    _close(got.numpy(), want.numpy())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_global_norm_sums_each_device_once(tiny):
    """The clip's global norm over gradients on two devices: no mix, and the
    same norm as the gradients on one device (each logical parameter
    counted once: a replicated bias is held by one rank only)."""
    grads = {f"g{i}": torch.from_numpy(np.random.default_rng(i).standard_normal(5).astype(np.float32))
             for i in range(4)}
    want = pt_train.global_norm(grads)
    rec = Placement()
    with rec:
        placed = {n: g.to(f"cpu:{i % 2}") for i, (n, g) in enumerate(grads.items())}
        got = pt_train.global_norm(placed)
        assert got.device == torch.device("cpu", 0)
        opt = pt_train.make_optimizer(learning_rate=1e-3, grad_clip_norm=0.5)
        params = {n: torch.zeros_like(g) for n, g in placed.items()}
        updates = opt.update(placed, opt.init(params), params)
        assert all(updates[n].device == g.device for n, g in placed.items())
    assert not rec.mixed, rec.mixed
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_tp_gradients_reduced_over_a_process_group(tiny, monkeypatch):
    """The data x model step's all_reduce across processes (a gloo group of
    one process): one all_reduce a rank of the row, over exactly the
    gradients on that rank's device (no device holds another's), put back
    on their own devices, with no mix, and equal to the same step without
    a group."""
    cfg, params = tiny
    images, ids, mask = (_t(a) for a in _batch(cfg, 12, b=8))
    mesh = _indexed_mesh(2, n=4)
    state = pt_train.init_train_state(_port_model(params), pt_train.make_optimizer(), mesh=mesh)
    _, want = pt_train.data_parallel_value_and_grad(state, mesh, images, ids, mask, torch.float32)
    want = {n: g.clone() for n, g in want.items()}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        grouped = _indexed_mesh(2, n=4, group=dist.group.WORLD)
        sizes = []
        all_reduce = dist.all_reduce

        def counted(buf, *args, **kwargs):
            sizes.append(buf.numel())
            return all_reduce(buf, *args, **kwargs)

        monkeypatch.setattr(dist, "all_reduce", counted)
        rec = Placement()
        with rec:
            state = pt_train.init_train_state(_port_model(params), pt_train.make_optimizer(), mesh=grouped)
            _, grads = pt_train.data_parallel_value_and_grad(state, grouped, images, ids, mask, torch.float32)
            expect = _expect_on(grouped, state)[0]
            for name, g in grads.items():
                assert g.device == expect[name], (name, g.device)
        assert not rec.mixed, rec.mixed[:10]
    finally:
        dist.destroy_process_group()
    per_rank = [sum(g.numel() for n, g in grads.items() if state.layout[n].rank == r) for r in range(2)]
    assert sizes == per_rank and 0 < per_rank[1] < per_rank[0]
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name
