"""The field seam (``minimal_nerf_torch/fields.py``): the NeRF MLPs as a
field equal to the functions they wrap, bit for bit; training and serving
take their field and its hooks from the one chooser; both kernel hooks pack
their weights through the one packing cache."""

import numpy as np
import pytest
import torch

from minimal_nerf_torch import fields, inference, train
from minimal_nerf_torch.data import procedural
from minimal_nerf_torch.kernels import fused_raymarch as t_fused
from minimal_nerf_torch.models.mlp import (init_nerf_mlp, map_params, nerf_mlp_apply,
                                           nerf_mlp_shapes)
from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network
from minimal_nerf_torch.models.ngp import NGPConfig, NGPField
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.checkpoint import flatten_tree, save_checkpoint
from minimal_nerf_torch.training.config import TrainConfig
from minimal_nerf_torch.training.trainer import Trainer

CFG = NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=4, fine_samples=4)


@pytest.fixture
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _params(seed=0):
    params = init_nerf_network(torch.Generator().manual_seed(seed), CFG, device="cpu",
                               gain=np.sqrt(6.0))
    for mlp in params.values():
        mlp["density"]["b"] += 0.5  # densities above 0, so the colors show
    return params


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(flatten_tree(a), flatten_tree(b)))


@pytest.mark.parametrize("mode", ["full", "single"])
def test_nerf_field_is_the_functions_it_wraps(mode):
    """``init``, ``shapes``, ``header`` and ``adam_options`` of the NeRF
    field are ``init_nerf_network`` (``init_nerf_mlp`` in single mode),
    ``nerf_mlp_shapes``, nothing and optax's defaults, bit for bit."""
    field = fields.NeRFField(CFG, "fused", mode)
    got = field.init(torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(3)
    want = (init_nerf_network(gen, CFG, device="cpu") if mode == "full" else
            init_nerf_mlp(gen, CFG.position_dim, CFG.direction_dim, device="cpu"))
    assert _equal(got, want)
    mlp = nerf_mlp_shapes(CFG.position_dim, CFG.direction_dim)
    assert field.shapes() == (mlp if mode == "single" else {"coarse": mlp, "fine": mlp})
    assert field.header() == {} and field.lr == {}
    grads = map_params(lambda t: torch.randn(t.shape, generator=gen), got)
    a, b = map_params(torch.clone, got), map_params(torch.clone, got)
    scalars = loop.adam_scalars(5e-4, 1, field.adam["b1"], field.adam["b2"])
    loop.adam_apply(a, grads, loop.adam_init(a), scalars, **field.adam_options(a))
    loop.adam_apply(b, grads, loop.adam_init(b), loop.adam_scalars(5e-4, 1))
    assert _equal(a, b) and not _equal(a, got)
    assert field.adam_options(a) == {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


@pytest.mark.parametrize("source", ["coarse", "fine", "both"])
def test_nerf_field_density_is_the_plain_mlps(source):
    """The density the grid's update reads: the plain MLP's density of the
    net(s) of the grid source (the max over both) at one point per "ray",
    bit for bit, in fp32 and bf16."""
    params = _params()
    pts = torch.rand((64, 3), generator=torch.Generator().manual_seed(1)) * 4 - 2
    dirs = torch.zeros((64, 3))
    dirs[:, 2] = -1.0
    for dtype in (None, torch.bfloat16):
        got = fields.NeRFField(CFG).density(params, pts, dtype, source)
        nets = ("coarse", "fine") if source == "both" else (source,)
        want = [nerf_mlp_apply(params[n], pts[:, None, :], dirs, 4, 2, compute_dtype=dtype)[0]
                [:, 0, 0] for n in nets]
        want = want[0] if len(want) == 1 else torch.maximum(*want)
        assert got.shape == (64,) and torch.equal(got, want)


def test_fused_step_through_the_field_equals_the_fused_hooks():
    """A train step given the NeRF field under ``fused`` equals one given
    ``loop.kernel_hooks("fused", "cpu")`` explicitly, bit for bit."""
    scenes, _ = procedural.make_procedural_scene((("train", 2),), height=8, width=8,
                                                 gt_samples=8, scene="object", device="cpu")
    scene = scenes["train"]
    static = loop.scene_static(scene)
    tcfg = TrainConfig(num_rays=16, precision="fp32", cropping_epochs=0, start_lr=5e-3)
    _, render_fn = loop.kernel_hooks("fused", "cpu")
    out = []
    for kw in (dict(field=fields.NeRFField(CFG, "fused")), dict(render_fn=render_fn)):
        step = loop.make_train_step(CFG, tcfg, static, device="cpu", **kw)
        params = _params()
        state = loop.adam_init(params)
        for s in range(2):
            params, state, metrics = step(params, state, scene.images, scene.poses, s, 7)
        out.append((params, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = out
    assert _equal(p0, p1) and _equal(s0["mu"], s1["mu"]) and _equal(s0["nu"], s1["nu"])
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


@pytest.fixture
def chooser(monkeypatch):
    """Records each field the chooser hands out (``make_field``,
    ``checkpoint_field``, ``default_field``) and each ``hooks()`` call on
    it: ``(chooser, field)`` and ``(field, hooks)`` in ``seen``."""
    seen = {"fields": [], "hooks": []}

    def record(field):
        if not getattr(field, "_recorded", False):
            real = field.hooks

            def hooks():
                got = real()
                seen["hooks"].append((field, got))
                return got

            field.hooks, field._recorded = hooks, True
        return field

    for name in ("make_field", "checkpoint_field", "default_field"):
        real = getattr(fields, name)

        def chosen(*a, _real=real, _name=name, **k):
            field = record(_real(*a, **k))
            seen["fields"].append((_name, field))
            return field

        monkeypatch.setattr(fields, name, chosen)
    return seen


def _train_args(root, scene, *extra):
    return ["--device", "cpu", "-n", "t", "-s", "2", "-r", "16", "--precision", "fp32",
            "--log-every", "1", "--kernel", "fused", "-rd", str(root), "full", "-b",
            str(scene), "-c", "4", "-f", "4", *extra]


@pytest.mark.parametrize("field", ["nerf", "ngp"])
def test_train_cli_takes_field_and_hooks_from_the_chooser(chooser, fixture_scene, tmp_path,
                                                          one_torch_thread, field):
    """``train full`` (``--field nerf`` by default, or ``ngp``): the field
    comes from ``fields.make_field``, the Trainer keeps it and renders
    through its hooks."""
    extra = ["--field", "ngp", "--occ-resolution", "8"] if field == "ngp" else []
    trainer = train.main(_train_args(tmp_path, fixture_scene, *extra))
    made = [f for name, f in chooser["fields"] if name == "make_field"]
    assert len(made) == 1 and made[0].name == field and trainer.field is made[0]
    hooked = [h for f, h in chooser["hooks"] if f is made[0]]
    assert (trainer.mlp_apply, trainer.render_fn) in hooked
    if field == "nerf":
        assert made[0].kernel == "fused" and trainer.mlp_apply is None
        assert trainer.render_fn.__qualname__.startswith("make_fused_render_fn")
    else:
        assert isinstance(made[0], NGPField) and trainer.train_config.start_lr == 1e-2


def test_trainer_without_a_field_takes_the_default_field(chooser, fixture_scene, tmp_path,
                                                         one_torch_thread):
    tcfg = TrainConfig(num_rays=16, max_steps=1, precision="fp32", kernel="pallas")
    trainer = Trainer(CFG, tcfg, fixture_scene, tmp_path, device="cpu")
    field = trainer.field
    assert any(n == "default_field" and f is field for n, f in chooser["fields"])
    assert all(f is field for _, f in chooser["fields"]) and field.kernel == "pallas"
    assert [(trainer.mlp_apply, trainer.render_fn)] == [h for _, h in chooser["hooks"]]
    assert trainer.mlp_apply.__qualname__.startswith("make_mlp_kernel_apply")


@pytest.mark.parametrize("kernel", ["fused", "pallas", "ngp"])
def test_render_chunk_takes_field_and_hooks_from_the_chooser(chooser, tmp_path, kernel):
    """``build_render_chunk`` of a fused, a pallas and an NGP checkpoint:
    the field from ``fields.checkpoint_field`` under the checkpoint's
    kernel, the render chunk's hooks from that field."""
    if kernel == "ngp":
        ngp = NGPField(NGPConfig(levels=2, log2_table=8, min_resolution=4, max_resolution=8))
        params, extra = ngp.init(torch.Generator().manual_seed(0), "cpu"), ngp.header()
    else:
        params, extra = _params(), {}
    tcfg = TrainConfig(kernel="fused" if kernel == "ngp" else kernel)
    path = save_checkpoint(tmp_path / "model=f-epoch=0-step=5.ckpt", params, 5, CFG.to_dict(),
                           tcfg.to_dict(), extra=dict({"mode": "full"}, **extra))
    chunk, _, _ = inference.build_render_chunk(str(path), rays=8, kernel=tcfg.kernel,
                                               device="cpu")
    (field, (mlp_apply, render_fn)), = chooser["hooks"]
    assert any(n == "checkpoint_field" and f is field for n, f in chooser["fields"])
    assert field.name == ("ngp" if kernel == "ngp" else "nerf")
    if kernel != "ngp":
        assert field.kernel == kernel
    if kernel == "pallas":
        assert mlp_apply.__qualname__.startswith("make_mlp_kernel_apply")
    o, d = torch.zeros(8, 3), torch.tensor([[0.0, 0.0, -1.0]] * 8)
    assert chunk(o + 4.0, d, torch.Generator().manual_seed(1)).shape == (8, 3)


@pytest.mark.parametrize("kernel,repacked", [("fused", 2), ("pallas", 1)])
def test_both_hooks_pack_through_the_one_cache(monkeypatch, kernel, repacked):
    """The fused render hook and the point kernels' MLP hook pack through
    ``fused_raymarch.PackingCache``: once per parameter state, again after
    an in-place update (the fused hook packs its whole tree, the point hook
    the MLP updated), on every call and keeping nothing while a (faked)
    capture of trained leaves runs, from the cache under a capture of frozen
    ones."""
    caches, packed = [], []
    real_call, real_pack = t_fused.PackingCache.__call__, t_fused.prepare_fused_mlp
    monkeypatch.setattr(t_fused.PackingCache, "__call__",
                        lambda self, *a: caches.append(self) or real_call(self, *a))
    monkeypatch.setattr(t_fused, "prepare_fused_mlp",
                        lambda p, dtype=None: packed.append(id(p)) or real_pack(p, dtype))
    capture = [False]
    monkeypatch.setattr(t_fused, "capturing", lambda t: capture[0])
    params = _params()
    mlp_apply, render_fn = fields.kernel_hooks(kernel, "cpu")
    o, d = torch.zeros(3, 3) + 4.0, torch.tensor([[0.0, 0.0, -1.0]] * 3)
    draws = {"coarse": torch.full((3, 4), 0.5), "eps": torch.full((3, 1), 0.5),
             "jitter": torch.full((3, 4, 1), 0.5)}

    def render():
        with torch.no_grad():
            return render_fn(params, CFG, o, d, mlp_apply=mlp_apply,
                             uniforms=draws)["fine_rgb_rays"]

    first = render()
    assert torch.equal(render(), first) and len(packed) == 2
    assert caches and all(c is caches[0] for c in caches)
    cache = caches[0]
    with torch.no_grad():
        params["fine"]["rgb"][1]["b"] += 1.0
    after = render()
    assert len(packed) == 2 + repacked and not torch.equal(after, first)
    entries = lambda: {k: tuple(map(id, v)) for k, v in cache.entries.items()}  # noqa: E731
    kept = entries()
    capture[0] = True
    for leaf in flatten_tree(params):
        leaf.requires_grad_(True)
    assert torch.equal(render(), after) and torch.equal(render(), after)
    assert len(packed) == 2 + repacked + 4 and entries() == kept
    for leaf in flatten_tree(params):
        leaf.requires_grad_(False)
    assert torch.equal(render(), after) and len(packed) == 2 + repacked + 4
