"""On-device LLM training: resumable AdamW fine-tuning over a mesh — twin of
``fraud_detection_tpu/models/train_llm.py``.

Fine-tunes the decoder of ``models/llm.py`` on explanation transcripts, on
the card that serves it:

  * Document stream -> fixed-shape (B, T+1) windows drawn by numpy exactly
    as the reference draws them (``batch_for_step``), so a resumed run sees
    the batches the uninterrupted run would have seen.
  * The initial weights are the reference's: ``init_params_threefry`` draws
    them from JAX's threefry stream at ``tcfg.seed``.
  * One step: every data row's forward (``use_flash=False``, as the
    reference trains), the next-token cross-entropy summed per row and added
    on the first device, one backward, then ``AdamW``: the port's own twin
    of optax's ``chain(clip_by_global_norm, adamw(warmup_cosine_decay_
    schedule(...)))`` as plain functions on tensors, rounding where optax
    rounds (``torch.optim.AdamW`` decays and clips in another order).
  * Meshes (``parallel/mesh.py``): ("data",) splits the batch, one replica
    of the weights a data device; ("data", "model") also splits the weights
    in the Megatron layout (``llm.shard_params``); ("data", "seq") runs
    attention over "seq" (``llm.ring_attention``, gradients flowing back
    through the rotation, or ``llm.ulysses_attention``); ("model",) and
    ("seq",) split only the weights or the sequence. A replica is the
    weights ``.to()`` its devices, so the gradients of every row add into
    the one set of weights, a replicated weight's exactly once.
  * One process per card: a mesh's first axis may span processes (torchrun
    or ``parallel/mesh.initialize_distributed``). Every process draws the
    same windows and takes its own data rows of them; the data rows'
    gradients are summed over the processes in rank order
    (``mesh.sum_in_rank_order``) before the update, so the replicated
    weights stay the same bits on every process. A model or sequence axis
    across processes moves activations with the collectives of
    ``parallel/mesh.py``, whose backwards carry the gradient back; the
    clip's global norm sums each split weight's parts over the processes.
  * Resume through ``checkpoint/train_state.py``: params and optimizer state
    in optax's leaf order (``params.<name>``, ``opt.NNNN``) and the step;
    a resumed run continues bit-identically (every backward is a fixed-order
    sum: see ``llm._EmbedRows`` and ``llm._expand_kv_heads``). Across
    processes the first one writes the whole state (split weights gathered)
    and every process resumes from it.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fraud_detection_tpu_torch.checkpoint import train_state as ts
from fraud_detection_tpu_torch.models.llm import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, ByteTokenizer, LanguageModel, Sharded,
    Transformer, TransformerConfig, _model_offset, forward,
    init_params_threefry, shard_params)
from fraud_detection_tpu_torch.parallel.mesh import (Mesh, collective_order,
                                                     spans, sum_in_rank_order)
from fraud_detection_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class LLMTrainConfig:
    steps: int = 200
    batch_size: int = 8           # global batch (split over the data axis)
    seq_len: int = 128            # tokens per example (T; windows are T+1)
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    decay_steps: Optional[int] = None  # cosine horizon; defaults to `steps`.
                                  # Set it when a run may be extended: the
                                  # schedule (not `steps`) is what resume
                                  # holds fixed, so `steps` stays out of the
                                  # snapshot fingerprint.
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    seed: int = 0
    remat: bool = False           # recompute each layer in backward

    def resolved_decay_steps(self) -> int:
        return self.decay_steps if self.decay_steps is not None else max(
            self.steps, self.warmup_steps + 1)


# ---------------------------------------------------------------------------
# Data: document stream -> deterministic fixed-shape windows
# ---------------------------------------------------------------------------

def pack_corpus(texts: Sequence[str], cfg: TransformerConfig) -> np.ndarray:
    """Byte-tokenize and concatenate the corpus into one token stream with
    BOS/EOS document boundaries (no padding, every position trains)."""
    tok = ByteTokenizer(cfg)
    parts: List[np.ndarray] = []
    for t in texts:
        ids = tok.encode(t)  # already BOS-prefixed
        parts.append(np.concatenate([ids, [cfg.EOS]]).astype(np.int32))
    stream = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    if stream.size < 2:
        raise ValueError("corpus too small to train on")
    return stream


def batch_for_step(stream: np.ndarray, step: int, tcfg: LLMTrainConfig) -> np.ndarray:
    """(B, T+1) window batch for a step — a pure function of (stream, step,
    seed), so resumed runs draw the exact batches the original would have."""
    rng = np.random.default_rng(np.random.SeedSequence([tcfg.seed, step]))
    span = tcfg.seq_len + 1
    if stream.size < span:
        raise ValueError(
            f"corpus stream ({stream.size} tokens) is smaller than one "
            f"(seq_len + 1 = {span})-token window; shrink seq_len or add data")
    # +1: the last valid start is stream.size - span (inclusive)
    starts = rng.integers(0, stream.size - span + 1, size=tcfg.batch_size)
    return np.stack([stream[s : s + span] for s in starts])


# ---------------------------------------------------------------------------
# The optimizer: optax's chain(clip_by_global_norm, adamw(schedule))
# ---------------------------------------------------------------------------

@dataclass
class OptState:
    """optax's state leaves: Adam's ``count``, ``mu`` and ``nu`` (one list
    of tensors a parameter, its parts' shapes, in its dtype) and the
    schedule's ``sched_count``."""

    count: int
    mu: Dict[str, List[torch.Tensor]]
    nu: Dict[str, List[torch.Tensor]]
    sched_count: int


class _Scalars(dict):
    """Values rounded to a tensor's dtype, as JAX rounds a Python scalar
    against an array, made once an update: a Python float for products and
    sums (torch multiplies in float32 and rounds once, as XLA does), a 0-dim
    tensor on the tensor's device for ``divisor`` (a Python divisor may
    become a multiply by its reciprocal on the card)."""

    def __call__(self, value: float, like: torch.Tensor, divisor: bool = False):
        key = (value, like.dtype, like.device if divisor else None)
        if key not in self:
            t = torch.full((), value, dtype=like.dtype)
            self[key] = t.to(like.device) if divisor else float(t)
        return self[key]


@dataclass(frozen=True)
class AdamW:
    """``optax.chain(optax.clip_by_global_norm(grad_clip),
    optax.adamw(optax.warmup_cosine_decay_schedule(0.0, learning_rate,
    warmup_steps, decay_steps), weight_decay=weight_decay))`` (b1 0.9, b2
    0.999, eps 1e-8) on dicts of tensor lists, step for step: the global
    norm of every leaf's float32 square-sum added in name order, the clip
    ``g / norm * clip`` where the norm reaches the clip, the moments
    ``(1 - b) g^k + b m``, the bias corrections ``1 - b^count`` in float32,
    ``m / (sqrt(v) + eps)``, plus ``wd * p``, times ``-lr(step)`` in the
    parameter's dtype, added to the parameter."""

    learning_rate: float
    warmup_steps: int
    decay_steps: int
    weight_decay: float
    grad_clip: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        if not self.decay_steps - self.warmup_steps > 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, got "
                f"decay_steps={self.decay_steps - self.warmup_steps}.")

    def schedule(self, count: int) -> np.float32:
        """``warmup_cosine_decay_schedule`` at ``count``, in float32."""
        f32 = np.float32
        peak = f32(self.learning_rate)
        if count < self.warmup_steps:
            frac = f32(1) - f32(count) / f32(self.warmup_steps)
            return (f32(0) - peak) * frac + peak
        decay = f32(self.decay_steps - self.warmup_steps)
        c = min(f32(count - self.warmup_steps), decay)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / decay))
        return peak * (f32(1) * cosine + f32(0))

    def init(self, params: Dict[str, List[torch.Tensor]]) -> OptState:
        def zeros():
            return {k: [torch.zeros_like(p) for p in ps]
                    for k, ps in params.items()}

        return OptState(0, zeros(), zeros(), 0)

    @torch.no_grad()
    def update(self, params: Dict[str, List[torch.Tensor]],
               grads: Dict[str, List[torch.Tensor]],
               state: OptState,
               leaf_sums: Optional[Callable[[List[str], List[torch.Tensor]],
                                            List[torch.Tensor]]] = None
               ) -> OptState:
        """One step: ``params`` and the state's moments updated in place;
        returns the state with its counts advanced. ``leaf_sums``: maps the
        leaves' square sums (name order) to the whole leaves' where a leaf's
        parts lie in several processes."""
        names = sorted(params)
        home = grads[names[0]][0].device
        sums = []
        for k in names:
            s = None
            for g in grads[k]:
                part = (g * g).sum().to(home)
                s = part if s is None else s + part
            sums.append(s)
        if leaf_sums is not None:
            sums = leaf_sums(names, sums)
        norm_sq = sums[0]
        for s in sums[1:]:
            norm_sq = norm_sq + s
        g_norm = torch.sqrt(norm_sq)
        clip = bool(g_norm >= self.grad_clip)
        count = state.count + 1
        bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(count)
        lr = -self.schedule(state.sched_count)
        c = _Scalars()
        for k in names:
            for p, g, mu, nu in zip(params[k], grads[k], state.mu[k],
                                    state.nu[k]):
                if clip:
                    g = (g / g_norm.to(p.device, g.dtype)) * c(
                        self.grad_clip, g)
                torch.add(g * c(1 - self.b1, g), mu * c(self.b1, mu), out=mu)
                torch.add((g * g) * c(1 - self.b2, g), nu * c(self.b2, nu),
                          out=nu)
                u = (mu / c(float(bc1), mu, True)) / (
                    torch.sqrt(nu / c(float(bc2), nu, True)) + c(self.eps, nu))
                u = u + p * c(self.weight_decay, p)
                torch.add(p, u * c(float(lr), u), out=p)
        return OptState(count, state.mu, state.nu, state.sched_count + 1)


def make_optimizer(tcfg: LLMTrainConfig) -> AdamW:
    return AdamW(learning_rate=tcfg.learning_rate,
                 warmup_steps=tcfg.warmup_steps,
                 decay_steps=tcfg.resolved_decay_steps(),
                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _loss_fn(params: Transformer, windows: torch.Tensor,
             cfg: TransformerConfig, remat: bool,
             seq_mesh: Optional[Mesh] = None,
             sp_impl: str = "ring") -> torch.Tensor:
    """Mean next-token cross-entropy over (B, T+1) windows, in float32.
    ``use_flash=False`` as in the reference; ``seq_mesh``: attention split
    over its "seq" axis (``sp_impl``: the ring or Ulysses); ``remat``: each
    layer recomputed in backward."""
    logits, _ = forward(params, windows[:, :-1], cfg, use_flash=False,
                        seq_mesh=seq_mesh, sp_impl=sp_impl, remat=remat)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           windows[:, 1:].reshape(-1))


@dataclass
class _Row:
    """One data row of the mesh: its devices (the model axis' under tensor
    parallelism, else one) and the sequence mesh its attention rides."""

    devices: List[torch.device]
    seq_mesh: Optional[Mesh] = None


def _rows(mesh: Optional[Mesh], device) -> List[_Row]:
    if mesh is None:
        return [_Row([resolve_device(device)])]
    subs = ([mesh.take(DATA_AXIS, r) if mesh.devices.ndim > 1 else None
             for r in range(mesh.local_size(DATA_AXIS))]
            if DATA_AXIS in mesh.axis_names else [mesh])
    rows = []
    for r, sub in enumerate(subs):
        if sub is None:           # a 1-D ("data",) mesh
            rows.append(_Row([mesh.data_devices[r]]))
        elif MODEL_AXIS in sub.axis_names:
            rows.append(_Row(sub.axis_devices(MODEL_AXIS)))
        elif SEQ_AXIS in sub.axis_names:
            rows.append(_Row([sub.home], sub))
        else:
            rows.append(_Row([sub.home]))
    return rows


def _replica(master: Dict[str, object], cfg: TransformerConfig,
             devs: List[torch.device]) -> Transformer:
    """The weights on one data row's devices, as ``.to()`` copies (the
    master tensors themselves where the devices are theirs), so the row's
    backward adds into the master gradients."""
    leaves = {}
    for name, leaf in master.items():
        if isinstance(leaf, Sharded):
            leaves[name] = Sharded([p.to(d) for p, d in zip(leaf.parts, devs)],
                                   leaf.dim, leaf.mesh)
        else:
            leaves[name] = leaf.to(devs[0])
    return Transformer.from_leaves(cfg, leaves, wrap=False)


def _parts(leaf) -> List[torch.Tensor]:
    return leaf.parts if isinstance(leaf, Sharded) else [leaf]


def _leaf_sums(master: Dict[str, object], mesh: Mesh):
    """``AdamW.update``'s ``leaf_sums`` where the model axis spans
    processes: a split leaf's square sum added over them in rank order, a
    replicated leaf's (the same on every process) kept."""
    split = {k for k, v in master.items() if isinstance(v, Sharded)}

    def whole(names: List[str], sums: List[torch.Tensor]):
        sum_in_rank_order([s for k, s in zip(names, sums) if k in split],
                          mesh)
        return sums

    return whole


def _step_grads(master: Dict[str, object], windows: np.ndarray,
                cfg: TransformerConfig, tcfg: LLMTrainConfig,
                rows: List[_Row], mesh: Optional[Mesh] = None,
                sp_impl: str = "ring"):
    """Loss and gradient of one (B, T+1) batch, split over the data rows
    (equal shares: the mean of the rows' means, added on the first device
    in row order); where the data axis spans processes, this process's rows
    of the batch, the gradients and the loss then summed over the processes
    in rank order, in place. Returns ({name: each part's gradient}, loss):
    the gradients are the weights' ``.grad``, left set."""
    across = mesh is not None and spans(mesh, DATA_AXIS)
    n_rows = len(rows) * (mesh.process_count if across else 1)
    first = mesh.process_index * len(rows) if across else 0
    per = windows.shape[0] // n_rows
    home = rows[0].devices[0]
    total = None
    # every row's collectives in one chain, so their backwards run in one
    # order on every process (parallel/mesh.collective_order)
    with collective_order():
        for r, row in enumerate(rows):
            lo = (first + r) * per
            win = torch.from_numpy(windows[lo:lo + per].astype(np.int64))
            part = _loss_fn(_replica(master, cfg, row.devices),
                            win.to(row.devices[0]), cfg, tcfg.remat,
                            row.seq_mesh, sp_impl).to(home)
            total = part if total is None else total + part
        loss = total / n_rows if n_rows > 1 else total
    loss.backward()
    grads = {k: [p.grad for p in _parts(v)] for k, v in master.items()}
    loss = loss.detach().clone()
    if across:
        sum_in_rank_order([g for gs in grads.values() for g in gs] + [loss],
                          mesh)
    return grads, loss


def _train_step(master: Dict[str, object], state: OptState,
                windows: np.ndarray, cfg: TransformerConfig,
                tcfg: LLMTrainConfig, opt: AdamW, rows: List[_Row],
                mesh: Optional[Mesh] = None, sp_impl: str = "ring"):
    """``_step_grads``, then the optimizer update. Returns (state, loss)
    with the weights updated in place."""
    grads, loss = _step_grads(master, windows, cfg, tcfg, rows, mesh, sp_impl)
    params = {k: _parts(v) for k, v in master.items()}
    spread = mesh is not None and spans(mesh, MODEL_AXIS)
    state = opt.update(params, grads, state,
                       _leaf_sums(master, mesh) if spread else None)
    for ps in params.values():
        for p in ps:
            p.grad = None
    return state, loss


# ---------------------------------------------------------------------------
# Checkpoint plumbing: weights and state <-> flat arrays, optax's leaf order
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as its raw uint16 bits (numpy has no
    bfloat16), which ``_device`` reads back bit for bit."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(like.device, like.dtype)


def _whole(leaf_parts: List[torch.Tensor], like) -> torch.Tensor:
    if isinstance(like, Sharded):
        return Sharded(leaf_parts, like.dim, like.mesh).gather()
    return leaf_parts[0]


def _split(a: np.ndarray, like) -> List[torch.Tensor]:
    """A whole snapshot array as ``like``'s parts: this process's slices of
    the model axis, each on its part's device."""
    if not isinstance(like, Sharded):
        return [_device(a, like)]
    first = _model_offset(like.mesh)
    pieces = np.split(a, like.mesh.shape[MODEL_AXIS], axis=like.dim)
    return [_device(x, p) for x, p in zip(pieces[first:], like.parts)]


def _flatten_state(master: Dict[str, object], state: OptState
                   ) -> Dict[str, np.ndarray]:
    """``params.<name>`` and ``opt.NNNN`` as the reference names them: opt
    leaves in optax's order (Adam's count, mu and nu by sorted name, the
    schedule's count)."""
    names = sorted(master)
    arrays = {f"params.{k}": _host(_whole(_parts(master[k]), master[k]))
              for k in names}
    leaves = [np.asarray(state.count, np.int32)]
    leaves += [_host(_whole(state.mu[k], master[k])) for k in names]
    leaves += [_host(_whole(state.nu[k], master[k])) for k in names]
    leaves.append(np.asarray(state.sched_count, np.int32))
    for i, leaf in enumerate(leaves):
        arrays[f"opt.{i:04d}"] = leaf
    return arrays


def _unflatten_state(arrays: Dict[str, np.ndarray], master: Dict[str, object],
                     state: OptState) -> OptState:
    """Load a snapshot into ``master`` (in place, each part on its device)
    and return its optimizer state."""
    names = sorted(master)
    with torch.no_grad():
        for k in names:
            for p, v in zip(_parts(master[k]), _split(arrays[f"params.{k}"],
                                                      master[k])):
                p.copy_(v)
    n = len(names)
    mu = {k: _split(arrays[f"opt.{1 + i:04d}"], master[k])
          for i, k in enumerate(names)}
    nu = {k: _split(arrays[f"opt.{1 + n + i:04d}"], master[k])
          for i, k in enumerate(names)}
    return OptState(int(arrays["opt.0000"]), mu, nu,
                    int(arrays[f"opt.{1 + 2 * n:04d}"]))


# ---------------------------------------------------------------------------
# Public trainer
# ---------------------------------------------------------------------------

def _init_master(cfg: TransformerConfig, tcfg: LLMTrainConfig,
                 mesh: Optional[Mesh], rows: List[_Row]) -> Dict[str, object]:
    """The trained weights: the reference's initial draw at ``tcfg.seed``
    on the first row's device, split over the model axis where the mesh has
    one, every tensor (every part) a leaf that requires its gradient."""
    params = init_params_threefry(cfg, tcfg.seed, rows[0].devices[0])
    if mesh is not None and MODEL_AXIS in mesh.axis_names:
        params = shard_params(params, cfg, mesh)
    master: Dict[str, object] = {}
    for name in params.param_names():
        leaf = params.param(name)
        if isinstance(leaf, Sharded):
            master[name] = Sharded([p.requires_grad_() for p in leaf.parts],
                                   leaf.dim, leaf.mesh)
        else:
            master[name] = leaf.detach().requires_grad_()
    return master


def _fingerprint(cfg: TransformerConfig, tcfg: LLMTrainConfig,
                 stream: np.ndarray, mesh: Optional[Mesh]) -> dict:
    # `steps` is the run length, not the setup: extending a run resumes.
    # The RESOLVED schedule horizon is what must match.
    tc = {k: (int(v) if isinstance(v, bool) else v)
          for k, v in sorted(tcfg.__dict__.items())
          if k not in ("steps", "decay_steps")}
    tc["resolved_decay_steps"] = tcfg.resolved_decay_steps()
    fp = {"config": {k: str(v) for k, v in sorted(cfg.__dict__.items())},
          "train_config": tc,
          "stream_sha256": hashlib.sha256(stream.tobytes()).hexdigest()}
    fp.update(ts.mesh_extra(mesh))
    return fp


def fit_language_model(
    texts: Sequence[str],
    cfg: Optional[TransformerConfig] = None,
    tcfg: Optional[LLMTrainConfig] = None,
    *,
    mesh: Optional[Mesh] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 0,
    device="cuda",
    sp_impl: str = "ring",
) -> Tuple[LanguageModel, List[float]]:
    """Fine-tune the byte-level decoder on a text corpus, on ``device`` or
    over ``mesh`` (axes ``("data",)``, ``("data", "model")``, ``("data",
    "seq")``, ``("model",)`` or ``("seq",)``; its first axis may span
    processes, one per card): batches split over "data", weights
    tensor-parallel over "model", attention sequence-parallel over "seq"
    (``sp_impl`` "ring" or "ulysses"). Every process of a mesh across
    processes calls it with the same arguments. Returns the trained
    ``LanguageModel`` (sharded as trained) and the per-step losses of THIS
    invocation."""
    cfg = cfg or TransformerConfig()
    tcfg = tcfg or LLMTrainConfig()
    if checkpoint_dir is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    stream = pack_corpus(texts, cfg)
    opt = make_optimizer(tcfg)
    if mesh is not None and DATA_AXIS in mesh.axis_names \
            and tcfg.batch_size % mesh.shape[DATA_AXIS]:
        raise ValueError(
            f"batch_size {tcfg.batch_size} not divisible by data axis "
            f"size {mesh.shape[DATA_AXIS]}")
    if mesh is not None and SEQ_AXIS in mesh.axis_names \
            and tcfg.seq_len % mesh.shape[SEQ_AXIS]:
        raise ValueError(
            f"seq_len {tcfg.seq_len} not divisible by seq axis "
            f"size {mesh.shape[SEQ_AXIS]}")
    rows = _rows(mesh, device)
    master = _init_master(cfg, tcfg, mesh, rows)
    state = opt.init({k: _parts(v) for k, v in master.items()})

    fingerprint = None
    start_step = 0
    if checkpoint_dir is not None:
        fingerprint = _fingerprint(cfg, tcfg, stream, mesh)
        snap = ts.load_for(checkpoint_dir, "language_model", fingerprint)
        if snap is not None:
            start_step, arrays = snap
            if start_step > tcfg.steps:
                # AdamW state cannot be rolled back; clamping would silently
                # return an over-trained model for a shorter request.
                raise ValueError(
                    f"snapshot in {checkpoint_dir} has already trained "
                    f"{start_step} steps but steps={tcfg.steps} was requested; "
                    "raise steps to extend the run or delete the snapshot to "
                    "retrain from scratch")
            state = _unflatten_state(arrays, master, state)

    losses: List[float] = []
    for step in range(start_step, tcfg.steps):
        state, loss = _train_step(master, state,
                                  batch_for_step(stream, step, tcfg), cfg,
                                  tcfg, opt, rows, mesh, sp_impl)
        losses.append(float(loss))
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}/{tcfg.steps} loss {losses[-1]:.4f}")
        if checkpoint_dir is not None and (
                (step + 1) % checkpoint_every == 0 or step + 1 == tcfg.steps):
            ts.save_train_state_once(
                mesh, checkpoint_dir, "language_model", step + 1,
                fingerprint, _flatten_state(master, state))

    leaves = {k: (Sharded([p.detach() for p in v.parts], v.dim, v.mesh)
                  if isinstance(v, Sharded) else v.detach())
              for k, v in master.items()}
    return LanguageModel(cfg, Transformer.from_leaves(cfg, leaves)), losses
