"""Plain PyTorch reference of the hierarchical radiance fields the cells run.

Written from the published models (Mildenhall et al., NeRF, ECCV 2020) and
the configuration files, independent of the package under test: it imports
neither it nor JAX, and it takes from the benchmark only the inputs (scene,
weights, grid, poses, seeds), never anything the program derived from them.

What it computes, in float32 with TF32 off (``Numerics``):

- the field (``Field``): density and color at points along rays, the
  density alone for the grid's update, and the optimizer's settings. The
  default is the NeRF MLP (``nerf_field``): 4 trunk layers on the position
  encoding, a skip that re-concatenates it, two more ReLU layers and a
  linear one, a ReLU density head, a 128-wide color layer on ``[h,
  direction encoding]`` and a sigmoid color head; encodings are
  frequency-major with cos before sin. Another field's reference
  (``reference/<field>.py``) supplies its own ``Field``;
- the render, whatever the field: stratified coarse times (or the
  occupancy grid's sampler), transmittance weights and colors, inverse-CDF
  fine times with jitter in the chosen bin, the sorted union, the fine
  pass;
- training: the pixels and frame of each step, the summed coarse and fine
  MSE, its gradients, Adam (``Adam``, the field's settings) with the LR
  schedule, and the occupancy grid's density EMA every ``update_every``
  steps;
- the draws: the seeded generators and the order each step or chunk draws
  from them, as the configuration's draw rule states (``step_generator``,
  ``mix_seed``), so both sides see the same random numbers.

The MLP's ``Numerics`` set two roundings: of the matmul inputs (``"fp32"``,
or the control's ``"fp8"``: e4m3 for values and e5m2 for gradients, each
scaled per tensor) and of the render passes' encoder inputs, the scaled
positions and the unit directions (``encoder``), which the configuration
states. The machinery hands a field's numerics to its functions unread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

PERM_STREAM, BATCH_STREAM, RENDER_STREAM, OCC_STREAM = 0x5EED, 1, 2, 0x0CC
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ---------------------------------------------------------------- the field

@dataclasses.dataclass(frozen=True)
class Adam:
    """A field's optimizer: Adam with bias correction, every leaf updated
    from its ``.grad`` (which it clears). A field whose optimizer differs
    (another ``b2`` or ``eps``, rows skipped on a zero gradient, decay on
    some leaves) gives an object with the same ``apply``."""
    b1: float = ADAM_B1
    b2: float = ADAM_B2
    eps: float = ADAM_EPS

    @torch.no_grad()
    def apply(self, ps: List[torch.Tensor], mu: List[torch.Tensor], nu: List[torch.Tensor],
              lr: torch.Tensor, count: int) -> None:
        """The ``count``-th update (0-based) at the learning rate ``lr``,
        in place."""
        dev = lr.device
        bc1 = 1 - torch.tensor(self.b1) ** (count + 1)
        bc2 = 1 - torch.tensor(self.b2) ** (count + 1)
        for p, m, v in zip(ps, mu, nu):
            g = p.grad
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(lr * (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev)) + self.eps))
            p.grad = None


@dataclasses.dataclass(frozen=True)
class Field:
    """The model a configuration runs, as the render and the train steps
    see it.

    - ``samples``: the group holding ``coarse_samples``, ``fine_samples``,
      ``near`` and ``far``;
    - ``point(params, which, x, d, num)``: density ``[N, S]`` and color
      ``[N, S, 3]`` at the points ``x [N, S, 3]`` of rays with directions
      ``d [N, 3]`` (not normalized) in the pass ``which`` (``"coarse"`` or
      ``"fine"``);
    - ``density(params, x, num)``: density ``[P]`` at points ``x [P, 3]``,
      which the grid's EMA update reads;
    - ``adam``: the optimizer (``Adam``)."""
    samples: Dict[str, Any]
    point: Callable
    density: Callable
    adam: Adam = Adam()


# ---------------------------------------------------------------- the MLP

@dataclasses.dataclass(frozen=True)
class Numerics:
    matmul: str = "fp32"            # "fp32" or "fp8"
    encoder: Optional[str] = None   # rounding of the encoder inputs: None, "bf16", "fp8"


def _quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the fp8 ``dtype`` with one scale per tensor (its
    largest magnitude onto the format's largest finite value)."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def round_encoder(x: torch.Tensor, how: Optional[str]) -> torch.Tensor:
    if how is None:
        return x
    if how == "bf16":
        return x.to(torch.bfloat16).float()
    if how == "fp8":
        return _quantize(x, torch.float8_e4m3fn)
    raise ValueError(f"unknown encoder rounding {how!r}")


class _Fp8MatMul(torch.autograd.Function):
    """``x @ w`` on e4m3 operands; the backward's products take the
    gradient in e5m2 (the usual fp8 training recipe), fp32 sums."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _quantize(x, torch.float8_e4m3fn), _quantize(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _quantize(g, torch.float8_e5m2)
        return gq @ wq.t(), xq.reshape(-1, xq.shape[-1]).t() @ gq.reshape(-1, gq.shape[-1])


def matmul(x: torch.Tensor, w: torch.Tensor, how: str) -> torch.Tensor:
    if how == "fp32":
        return x @ w
    if how == "fp8":
        return _Fp8MatMul.apply(x, w)
    raise ValueError(f"unknown matmul precision {how!r}")


def encode(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """``[..., C] -> [..., 2 * octaves * C]``: for each octave ``i``,
    ``cos(2^i pi x)`` over the C channels, then ``sin``."""
    freqs = (2.0 ** torch.arange(octaves, dtype=torch.float32, device=x.device)) * math.pi
    ang = x[..., None, :] * freqs[:, None]
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-2).reshape(
        *x.shape[:-1], 2 * octaves * x.shape[-1])


def mlp(p: Dict[str, Any], pos_enc: torch.Tensor, dir_enc: Optional[torch.Tensor], how: str):
    """Density ``[...]`` and color ``[..., 3]`` of one MLP (color None
    without ``dir_enc``)."""
    lin = lambda layer, x: matmul(x, layer["w"], how) + layer["b"]  # noqa: E731
    h = pos_enc
    for layer in p["trunk"]:
        h = torch.relu(lin(layer, h))
    h = torch.relu(lin(p["feature"][0], torch.cat([h, pos_enc], dim=-1)))
    h = torch.relu(lin(p["feature"][1], h))
    h = lin(p["feature"][2], h)
    sigma = torch.relu(lin(p["density"], h))[..., 0]
    if dir_enc is None:
        return sigma, None
    r = torch.relu(lin(p["rgb"][0], torch.cat([h, dir_enc], dim=-1)))
    return sigma, torch.sigmoid(lin(p["rgb"][1], r))


def nerf_field(cfg: Dict) -> Field:
    """The NeRF MLP of ``cfg["nerf"]``, one per pass (``params["coarse"]``,
    ``params["fine"]``). In a render pass positions are scaled by ``1/pi``
    into the encoding's range and the encoder inputs rounded as ``num``
    states; the grid's update reads the coarse MLP on plain encoder
    inputs, outside the render passes."""
    nerf = cfg["nerf"]

    def point(params, which, x, d, num: Numerics):
        pe = encode(round_encoder(x * (1.0 / math.pi), num.encoder), nerf["position_dim"])
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        de = encode(round_encoder(dn, num.encoder), nerf["direction_dim"])
        de = de[:, None, :].expand(*x.shape[:-1], de.shape[-1])
        return mlp(params[which], pe, de, num.matmul)

    def density(params, x, num: Numerics):
        return mlp(params["coarse"], encode(x / math.pi, nerf["position_dim"]), None,
                   num.matmul)[0]

    return Field(samples=nerf, point=point, density=density)


def reference_numerics(cfg: Dict) -> Numerics:
    """The MLP's reference numerics: fp32 matmuls, the encoder inputs
    rounded as the configuration states."""
    return Numerics("fp32", cfg["nerf"].get("encoder_inputs"))


def control_numerics(cfg: Dict) -> Numerics:
    """The MLP's control: every rounding the configuration states at bf16 taken
    one step lower, to fp8."""
    enc = cfg["nerf"].get("encoder_inputs")
    return Numerics("fp8", "fp8" if enc else None)


# ---------------------------------------------------------------- rendering

def pass_color(field: Field, params, which: str, o, d, ts, num):
    """One render pass of ``field`` over times ``ts [N, S]``: ``(color
    [N, 3], weights [N, S])``."""
    sigma, rgb = field.point(params, which, o[:, None, :] + ts[..., None] * d[:, None, :], d,
                             num)
    deltas = torch.cat([ts[:, 1:] - ts[:, :-1], torch.full_like(ts[:, :1], 1e10)], dim=1)
    tau = sigma * deltas
    excl = torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(tau[:, :-1], dim=1)], dim=1)
    weights = (1.0 - torch.exp(-tau)) * torch.exp(-excl)
    return torch.sum(weights[..., None] * rgb, dim=1), weights


# ---------------------------------------------------------------- sampling

def stratified_times(s: int, near: float, far: float, u: torch.Tensor) -> torch.Tensor:
    """``s`` times per ray on ``[near, far]``, one in each equal bin at ``u``."""
    step = (far - near) / s
    base = near + step * torch.arange(s, dtype=torch.float32, device=u.device)
    return base[None, :] + u * step


def occupied(grid: torch.Tensor, occ: Dict, force_all: bool) -> torch.Tensor:
    """The grid's occupancy: above ``max(threshold, rel * mean)``, or every
    cell inside the warmup."""
    thr = torch.maximum(torch.tensor(occ["threshold"], device=grid.device),
                        occ["rel_threshold"] * grid.mean())
    return (grid > thr) | bool(force_all)


def occupancy_times(o, d, mask: torch.Tensor, occ: Dict, s: int, near: float, far: float,
                    eps_u: torch.Tensor, frac_u: torch.Tensor) -> torch.Tensor:
    """Coarse times from the occupancy of each of ``num_bins`` uniform bins
    at its midpoint (1 occupied, ``floor`` empty inside the grid's box, 0
    outside; uniform for a ray with no weight), one stratified inverse-CDF
    bin per sample, a uniform place inside it, sorted."""
    g, b = occ["resolution"], occ["num_bins"]
    width = (far - near) / b
    mids = near + (torch.arange(b, dtype=torch.float32, device=o.device) + 0.5) * width
    pos = o[:, None, :] + mids[None, :, None] * d[:, None, :]
    v = torch.floor((pos + occ["bound"]) * (g / (2.0 * occ["bound"]))).to(torch.int64)
    inside = torch.all((v >= 0) & (v < g), dim=-1)
    vc = v.clamp(0, g - 1)
    hit = mask[vc[..., 0], vc[..., 1], vc[..., 2]] & inside
    w = torch.where(hit, 1.0, torch.where(inside, occ["floor"], 0.0))
    w = torch.where(w.sum(dim=1, keepdim=True) > 0, w, torch.ones_like(w))
    cdf = torch.cumsum(w, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    u = torch.arange(s, dtype=torch.float32, device=o.device)[None, :] / s + eps_u / s
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=False).clamp(max=b - 1)
    return torch.sort(near + (idx.float() + frac_u) * width, dim=1).values


def fine_union(coarse_ts, weights, samples: Dict, eps_u, jitter_u) -> torch.Tensor:
    """The sorted union of the coarse times and ``fine_samples`` times drawn
    from the coarse weights' piecewise-constant CDF, each uniform inside
    its chosen bin between neighbouring coarse times (``near`` and ``far``
    close the ends)."""
    near, far, sf = samples["near"], samples["far"], samples["fine_samples"]
    w = weights.detach()
    cdf = torch.cumsum(w, dim=1)
    cdf = cdf / (cdf[:, -1:] + 1e-10)
    u = torch.arange(sf, dtype=torch.float32, device=w.device)[None, :] / sf + eps_u / sf
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=False)
    n = coarse_ts.shape[0]
    bounds = torch.cat([torch.full((n, 1), near, device=w.device), coarse_ts,
                        torch.full((n, 1), far, device=w.device)], dim=1)
    lo, hi = torch.gather(bounds, 1, idx), torch.gather(bounds, 1, idx + 1)
    fine = lo + (hi - lo) * jitter_u
    return torch.sort(torch.cat([fine, coarse_ts], dim=1), dim=1).values


def render(field: Field, params, cfg: Dict, o, d, draws: Dict, num, mask=None):
    """``(coarse color, fine color)`` of ``field`` for rays ``o, d [N, 3]``
    on their draws (``draw_uniforms``); ``mask`` is the occupancy (None:
    stratified coarse times)."""
    s = field.samples
    sc = s["coarse_samples"]
    if mask is None:
        cts = stratified_times(sc, s["near"], s["far"], draws["coarse"])
    else:
        cts = occupancy_times(o, d, mask, cfg["occupancy"], sc, s["near"], s["far"],
                              draws["coarse_eps"], draws["coarse_frac"])
    coarse, weights = pass_color(field, params, "coarse", o, d, cts, num)
    all_ts = fine_union(cts, weights, s, draws["eps"], draws["jitter"])
    fine, _ = pass_color(field, params, "fine", o, d, all_ts, num)
    return coarse, fine


# ---------------------------------------------------------------- draws

def step_generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
             + stream * 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def mix_seed(*ints: int) -> int:
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def draw_uniforms(cfg: Dict, samples: Dict, n: int,
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A render's uniforms in the order it draws them: the coarse times'
    (under occupancy a per-ray offset, then the in-bin places), the fine
    offset, the fine jitter; ``samples`` is the field's (``Field``)."""
    rand = lambda *shape: torch.rand(shape, generator=gen, device=gen.device)  # noqa: E731
    out = {}
    if cfg.get("occupancy"):
        out["coarse_eps"] = rand(n, 1)
        out["coarse_frac"] = rand(n, samples["coarse_samples"])
    else:
        out["coarse"] = rand(n, samples["coarse_samples"])
    out["eps"] = rand(n, 1)
    out["jitter"] = rand(n, samples["fine_samples"], 1)[..., 0]
    return out


def pixel_rays(xs, ys, height: int, width: int, focal: float, c2w):
    """Rays through pixel centers' corners ``(x, y)`` of a pinhole camera
    (``-z`` forward, ``+y`` up), directions not normalized."""
    dirs = torch.stack([(xs - width * 0.5) / focal, -(ys - height * 0.5) / focal,
                        -torch.ones_like(xs)], dim=-1)
    d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    return c2w[:3, 3].expand(d.shape), d


# ---------------------------------------------------------------- serving

@torch.no_grad()
def render_frame(params, cfg: Dict, pose, height: int, width: int, focal: float,
                 frame_seed: int, chunk: int, num, grid=None,
                 chunks_per_block: int = 1, field: Optional[Field] = None) -> torch.Tensor:
    """One delivered frame ``[H, W, 3]`` float in ``[0, 1]`` (fine colors):
    chunk ``i`` of ``chunk`` pixels in row-major order draws from the
    generator of ``mix_seed(frame_seed, i)``; ``field`` defaults to the
    NeRF MLP."""
    field = field or nerf_field(cfg)
    dev = pose.device
    mask = None if grid is None else occupied(grid, cfg["occupancy"], False)
    n_pix = height * width
    out = []
    starts = list(range(0, n_pix, chunk))
    for b in range(0, len(starts), chunks_per_block):
        block = starts[b:b + chunks_per_block]
        flat = torch.arange(block[0], min(block[-1] + chunk, n_pix), device=dev)
        o, d = pixel_rays((flat % width).float(), (flat // width).float(), height, width,
                          focal, pose)
        parts = [draw_uniforms(cfg, field.samples, min(lo + chunk, n_pix) - lo,
                               torch.Generator(device=dev).manual_seed(
                                   mix_seed(frame_seed, b + j)))
                 for j, lo in enumerate(block)]
        draws = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        out.append(render(field, params, cfg, o, d, draws, num, mask)[1])
    return torch.cat(out).reshape(height, width, 3)


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """Colors to 8 bits, clipped, then truncated (the served frame's rule)."""
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------- training

def lr_at(train: Dict, count: int, steps_per_epoch: int) -> torch.Tensor:
    """The LR of the ``count``-th update (0-based): ``max(start * gamma^epoch,
    floor)`` with ``gamma = (end / start)^(1 / decay_epochs)``, per epoch."""
    gamma = (train["end_lr"] / train["start_lr"]) ** (1.0 / train["lr_decay_epochs"])
    lr = (torch.tensor(train["start_lr"], dtype=torch.float32)
          * torch.tensor(gamma, dtype=torch.float32) ** (count // steps_per_epoch))
    return torch.clamp(lr, min=train["lr_floor"])


def step_draws(cfg: Dict, samples: Dict, step: int, seed: int, num_frames: int, height: int,
               width: int, device) -> Dict[str, Any]:
    """A train step's frame (the epoch's permutation), its pixels (the
    center half while ``epoch < cropping_epochs``) and render uniforms."""
    train = cfg["train"]
    spe = train.get("steps_per_epoch") or num_frames
    perm = torch.randperm(num_frames, generator=step_generator(seed, step // spe, PERM_STREAM,
                                                                "cpu"))
    frame = int(perm[step % spe % num_frames])
    crop = step // spe < train["cropping_epochs"]
    ew, eh = (width // 4, height // 4) if crop else (0, 0)
    gen = step_generator(seed, step, BATCH_STREAM, device)
    n = train["num_rays"]
    xs = torch.randint(ew, width - ew, (n,), generator=gen, device=device)
    ys = torch.randint(eh, height - eh, (n,), generator=gen, device=device)
    uniforms = draw_uniforms(cfg, samples, n, step_generator(seed, step, RENDER_STREAM, device))
    return {"frame": frame, "xs": xs, "ys": ys, "uniforms": uniforms}


@torch.no_grad()
def update_grid(grid: torch.Tensor, params, cfg: Dict, step: int, seed: int, num,
                field: Field) -> torch.Tensor:
    """``max(decay * grid, sigma)``: the field's density (``Field.density``)
    at one point per cell, jittered uniformly inside it."""
    occ = cfg["occupancy"]
    g, bound = occ["resolution"], occ["bound"]
    cell = 2.0 * bound / g
    dev = grid.device
    c = -bound + (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * cell
    xx, yy, zz = torch.meshgrid(c, c, c, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)
    u = torch.rand((g ** 3, 3), generator=step_generator(seed, step, OCC_STREAM, dev),
                   device=dev)
    pts = pts + (u - 0.5) * cell
    sigma = torch.cat([field.density(params, p, num) for p in torch.split(pts, 1 << 16)])
    return torch.maximum(grid * occ["decay"], sigma.reshape(g, g, g))


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def unflatten(tree, flat: List[torch.Tensor]):
    """``tree``'s layout with ``flat`` (in ``leaves``' order) as its leaves."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def adam_state(params) -> Dict[str, Any]:
    """Fresh Adam moments for ``params``' leaves and a zero count."""
    ps = leaves(params)
    return {"mu": [torch.zeros_like(p).float() for p in ps],
            "nu": [torch.zeros_like(p).float() for p in ps], "count": 0}


def step_loss_and_grads(field: Field, params, cfg: Dict, images: torch.Tensor,
                        poses: torch.Tensor, focal: float, dr: Dict[str, Any], num, mask=None,
                        block_rays: int = 1024):
    """One step's loss, its coarse part and the gradients (summed into
    ``params``' ``.grad``) on its draws ``dr`` (``step_draws``): the mean
    squared error of its coarse and of its fine colors against its pixels,
    summed, accumulated over blocks of ``block_rays`` rays."""
    height, width = images.shape[1], images.shape[2]
    o, d = pixel_rays(dr["xs"].float(), dr["ys"].float(), height, width, focal,
                      poses[dr["frame"]])
    rgb = images[dr["frame"], dr["ys"], dr["xs"]].float() / 255.0
    n = rgb.shape[0]
    total = total_coarse = 0.0
    for lo in range(0, n, block_rays):
        sl = slice(lo, min(lo + block_rays, n))
        draws = {k: v[sl] for k, v in dr["uniforms"].items()}
        coarse, fine = render(field, params, cfg, o[sl], d[sl], draws, num, mask)
        coarse_loss = torch.sum((coarse - rgb[sl]) ** 2) / (3 * n)
        loss = coarse_loss + torch.sum((fine - rgb[sl]) ** 2) / (3 * n)
        loss.backward()
        total += float(loss.detach())
        total_coarse += float(coarse_loss.detach())
    return total, total_coarse


def train_steps(params0, cfg: Dict, images: torch.Tensor, poses: torch.Tensor, focal: float,
                seed: int, start_step: int, num_steps: int, num, grid0=None,
                block_rays: int = 1024, state: Optional[Dict[str, Any]] = None,
                grids: Optional[Dict[int, torch.Tensor]] = None,
                field: Optional[Field] = None) -> Dict[str, Any]:
    """``num_steps`` train steps of ``field`` (default the NeRF MLP) from
    ``start_step`` on the Adam ``state`` (``adam_state``'s layout; default
    fresh moments), ``params0`` and ``grid0`` left as they are.

    With occupancy, each step whose number ``update_every`` divides updates
    the grid first (``update_grid``), and the step's coarse samples follow
    the grid after it; ``grids`` maps such a step to the grid to follow in
    place of the reference's own update (another side's, which this run is
    held to from there on), the own update still returned.

    Returns each step's loss and its coarse part, the parameters and the
    state after the last step, the grid the last step followed (``grid``)
    and the reference's own update at each update step (``updates``)."""
    field = field or nerf_field(cfg)
    train = cfg["train"]
    nf = images.shape[0]
    spe = train.get("steps_per_epoch") or nf
    dev = images.device
    params = map_tree(lambda t: t.detach().clone().float().requires_grad_(True), params0)
    ps = leaves(params)
    state = state or adam_state(params0)
    mu = [m.detach().clone().float() for m in state["mu"]]
    nu = [v.detach().clone().float() for v in state["nu"]]
    grid = None if grid0 is None else grid0.clone()
    occ = cfg.get("occupancy")
    losses, coarse_losses, updates = [], [], {}
    count = state["count"]
    for step in range(start_step, start_step + num_steps):
        dr = step_draws(cfg, field.samples, step, seed, nf, images.shape[1], images.shape[2],
                        dev)
        mask = None
        if occ:
            if step % occ["update_every"] == 0:
                updates[step] = update_grid(grid, params, cfg, step, seed, num, field)
                grid = (grids or {}).get(step, updates[step]).clone()
            mask = occupied(grid, occ, step < occ["warmup_steps"])
        loss, coarse = step_loss_and_grads(field, params, cfg, images, poses, focal, dr, num,
                                           mask, block_rays)
        losses.append(loss)
        coarse_losses.append(coarse)
        field.adam.apply(ps, mu, nu, lr_at(train, count, spe).to(dev), count)
        count += 1
    return {"losses": losses, "coarse_losses": coarse_losses,
            "params": [p.detach() for p in ps], "mu": mu, "nu": nu, "count": count,
            "grid": grid, "updates": updates}
