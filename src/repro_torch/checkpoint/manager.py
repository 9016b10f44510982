"""Atomic, async-capable checkpoints in the JAX package's on-disk layout
(port of ``repro/checkpoint/manager.py``).

Layout (the interface: the JAX package and the port read each other's):

    <dir>/step_00001230/           written as .tmp_step_..., then renamed
        index.json                 {"step", "leaves": {key: {shape, dtype}},
                                    "extra"}
        <key>.npy                  one file per leaf; key = the leaf's
                                   "/"-joined tree path with "__" for "/"
    <dir>/LATEST                   the newest committed step's directory name

* commit is one directory rename: a crash mid-write never corrupts the
  latest checkpoint, and a stale ``.tmp_`` directory is replaced;
* async saves copy the tree to host memory before the writer thread starts
  (the optimizer may update tensors in place), so a thread never writes a
  later step;
* keep-last-k GC;
* dtypes numpy cannot name without ``ml_dtypes`` (bfloat16, float8_e4m3fn)
  are written as raw words under the header JAX's files carry (``<V2`` /
  ``<V1``) with the real name in ``index.json``, and read back by
  reinterpreting the bits by that name. No ``torch.save``.

A ``QuantTensor`` leaf is two leaves, ``<path>__q`` and ``<path>__scale``,
as JAX's pytree flattening names them. Adapter banks: ``save_adapters``
writes named adapter trees with per-name ``PEFTConfig`` records in the
index; ``adapter_index`` / ``load_adapter`` read the index without the
leaves, or one adapter's leaves, for the disk-backed ``AdapterStore``.

Restores put every leaf on an explicit device, the card by default.

On a mesh (one process per rank): ``save(..., mesh=, spec_tree=)`` gathers
every split leaf whole over its axes (``sharding.specs.gather_leaf``; all
ranks take part) and global rank 0 alone writes, in the same layout, so
JAX's ``CheckpointManager.restore`` reads it; ``restore(..., mesh=,
spec_tree=)`` cuts each leaf to the rank's block under ``spec_tree`` as it
is read: an elastic restore onto any mesh, whatever mesh saved it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.quant.core import QuantMeta, QuantTensor, dtype_name

Tree = Any

_SEP = "__"

# torch dtypes numpy holds as themselves
_NUMPY_DTYPES = {torch.float32, torch.float64, torch.float16, torch.int8,
                 torch.uint8, torch.int16, torch.int32, torch.int64,
                 torch.bool}
# dtypes numpy cannot name: (header descr JAX's files carry, word of the
# same width, torch dtype)
_RAW = {"bfloat16": ("<V2", np.int16, torch.bfloat16),
        "float8_e4m3fn": ("<V1", np.int8, torch.float8_e4m3fn)}
_RAW_NAME = {v[2]: k for k, v in _RAW.items()}


def _key(prefix: str, k: Any) -> str:
    """A child's key: the "/"-joined tree path with "__" for every "/" (a
    dict key may hold "/" itself, as an adapter tree's weight paths do)."""
    k = str(k).replace("/", _SEP)
    return f"{prefix}{_SEP}{k}" if prefix else k


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """{"a__b__c": tensor} over nested dicts, keys sorted; a QuantTensor
    contributes ``__q`` and ``__scale``."""
    if isinstance(tree, QuantTensor):
        return {f"{prefix}{_SEP}q": tree.q, f"{prefix}{_SEP}scale": tree.scale}
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], _key(prefix, k)))
    return out


def _to_host(v: Any) -> Tuple[np.ndarray, str]:
    """(numpy array to write, index dtype name) of one leaf, copied to host
    memory now."""
    if isinstance(v, np.ndarray) or np.isscalar(v):
        arr = np.array(v)
        return arr, str(arr.dtype)
    t = v.detach()
    if t.dtype in _RAW_NAME:
        name = _RAW_NAME[t.dtype]
        word = _RAW[name][1]
        bits = t.view(torch.int16 if word == np.int16 else torch.int8)
        return bits.to("cpu", copy=True).numpy(), name
    if t.dtype not in _NUMPY_DTYPES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return t.to("cpu", copy=True).numpy(), dtype_name(t.dtype)


def _save_leaf(path: str, arr: np.ndarray, name: str) -> None:
    if name not in _RAW:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _RAW[name][0], "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes(order="C"))


def _load_leaf(path: str, name: str, device: torch.device) -> torch.Tensor:
    arr = np.load(path)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if name in _RAW:
        _, word, dt = _RAW[name]
        return torch.from_numpy(arr.view(word)).view(dt).to(device)
    if str(arr.dtype) != name:
        raise ValueError(f"{path}: file holds {arr.dtype}, index says {name}")
    return torch.from_numpy(arr).to(device)


def _nest(flat: Dict[str, Any]) -> Tree:
    """Nested dicts from "__"-joined keys (the index alone gives the tree)."""
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _like(tree_like: Tree, flat: Dict[str, Any], prefix: str = "") -> Tree:
    """``flat`` in the structure of ``tree_like`` (QuantTensor leaves keep
    their meta)."""
    if isinstance(tree_like, QuantTensor):
        return QuantTensor(_get(flat, f"{prefix}{_SEP}q"),
                           _get(flat, f"{prefix}{_SEP}scale"), tree_like.meta)
    if isinstance(tree_like, Mapping):
        return {k: _like(v, flat, _key(prefix, k))
                for k, v in tree_like.items()}
    return _get(flat, prefix)


def _get(flat: Dict[str, Any], key: str) -> Any:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    return flat[key]


def _quant_nodes(tree: Tree, meta: QuantMeta, load, keep,
                 prefix: str = "") -> Tree:
    """``tree`` of flat keys, each leaf read by ``load(key)`` and handed to
    ``keep(path, leaf)`` before the next is read; every {"q": int8,
    "scale"} node is one QuantTensor leaf."""
    if isinstance(tree, Mapping):
        if set(tree) == {"q", "scale"}:
            q = load(tree["q"])
            if q.dtype == torch.int8:
                return keep(prefix, QuantTensor(q, load(tree["scale"]), meta))
            return {"q": keep(f"{prefix}/q", q),
                    "scale": keep(f"{prefix}/scale", load(tree["scale"]))}
        return {k: _quant_nodes(v, meta, load, keep,
                                f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return keep(prefix, load(tree))


def _keep_all(_path, leaf):
    return leaf


def _peft_cfg(d: Mapping):
    from repro_torch.core.peft import PEFTConfig
    pd = dict(d)
    pd["target_patterns"] = tuple(pd.get("target_patterns", ()))
    return PEFTConfig(**pd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._split_pending = False      # a mesh save not yet waited for
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree, blocking: bool = True,
             extra: Optional[Dict] = None, *, mesh=None,
             spec_tree: Optional[Tree] = None) -> None:
        """Write ``tree`` as step ``step``. The leaves are copied to host
        memory before this returns, also when ``blocking=False`` (then a
        daemon thread writes them; ``wait()`` joins it). With ``mesh``:
        ``tree`` holds the rank's blocks under ``spec_tree`` (None: all
        whole); every rank calls this, the split leaves are gathered whole
        and global rank 0 writes them; the ranks return once it is written
        (``blocking``) or meet again in ``wait()``."""
        if mesh is not None:
            self._save_split(step, tree, blocking, extra, mesh, spec_tree)
            return
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self._start(step, host, blocking, extra)

    def _start(self, step, host, blocking, extra) -> None:
        if blocking:
            self._write(step, host, extra)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra), daemon=True)
            self._thread.start()

    def _save_split(self, step, tree, blocking, extra, mesh,
                    spec_tree) -> None:
        """Every rank gathers each leaf whole (a collective), one leaf at a
        time; global rank 0 alone keeps the host copies and writes them.
        The ranks leave together once the write is done (blocking) or, when
        not, at the next ``wait()`` (which every rank calls)."""
        import torch.distributed as dist

        from repro_torch.sharding.specs import gather_leaf
        specs = _flatten(spec_tree) if spec_tree is not None else {}
        writer = dist.get_rank() == 0
        self.wait()
        host = {}
        for k, v in _flatten(tree).items():
            leaf = gather_leaf(mesh, v, specs.get(k, ()))
            if writer:
                host[k] = _to_host(leaf)
            del leaf
        if writer:
            self._start(step, host, blocking, extra)
        if blocking:
            dist.barrier()
        else:
            self._split_pending = True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._split_pending:
            import torch.distributed as dist
            self._split_pending = False
            dist.barrier()

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: Optional[Dict]) -> None:
        name = f"step_{step:010d}"
        tmp = os.path.join(self.dir, f".tmp_{name}")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "leaves": {}, "extra": extra or {}}
        for key, (arr, dt) in host.items():
            _save_leaf(os.path.join(tmp, key + ".npy"), arr, dt)
            index["leaves"][key] = {"shape": list(arr.shape), "dtype": dt}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic commit
        with open(os.path.join(self.dir, "LATEST"), "w") as f:
            f.write(name)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def _step_dir(self, step: Optional[int]) -> Tuple[str, Dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "index.json")) as f:
            return d, json.load(f)

    def _load(self, d: str, index: Dict, device: torch.device,
              only=None, keep=_keep_all) -> Dict[str, torch.Tensor]:
        """{flat key: leaf}, each leaf handed to ``keep(path, leaf)`` (its
        "/"-joined path) before the next is read."""
        return {k: keep(k.replace(_SEP, "/"), _load_leaf(
                    os.path.join(d, k + ".npy"), v["dtype"], device))
                for k, v in index["leaves"].items()
                if only is None or only(k)}

    def restore(self, tree_like: Optional[Tree] = None,
                step: Optional[int] = None, *,
                device: DeviceLike = "cuda", keep=_keep_all, mesh=None,
                spec_tree: Optional[Tree] = None) -> Tree:
        """Load step ``step`` (default the latest) onto ``device``, in the
        structure of ``tree_like`` when given (its leaves are not read), else
        as the nested dicts the index's keys spell. ``keep(path, leaf)``
        takes each leaf as it is read and returns what the tree holds (a
        split model keeps its slice, so no whole tree is ever held). With
        ``mesh`` (and ``keep`` left alone) each leaf is cut to this rank's
        block under ``spec_tree`` (None: all whole), whatever mesh saved
        it."""
        if mesh is not None:
            if keep is not _keep_all:
                raise ValueError("pass keep= or mesh=, not both")
            from repro_torch.sharding.specs import place_leaf
            specs = _flatten(spec_tree) if spec_tree is not None else {}
            dev = resolve_device(device)

            def keep(path, leaf):
                spec = specs.get(path.replace("/", _SEP), ())
                return place_leaf(mesh, leaf, spec, dev)
        d, index = self._step_dir(step)
        flat = self._load(d, index, resolve_device(device), keep=keep)
        if tree_like is None:
            return _nest(flat)
        return _like(tree_like, flat)

    def extra(self, step: Optional[int] = None) -> Dict:
        return self._step_dir(step)[1].get("extra", {})

    # -- quantized weight trees ----------------------------------------------
    def save_quantized(self, step: int, qparams: Tree, quant_cfg,
                       blocking: bool = True) -> None:
        """Persist a quantized parameter tree (``quant.quantize_params``
        output): int8 codes and fp32 scales as ordinary leaves, the
        QuantConfig as index metadata so the restore is self-describing."""
        extra = {"kind": "quantized_params",
                 "quant": dataclasses.asdict(quant_cfg)}
        self.save(step, qparams, blocking=blocking, extra=extra)

    def restore_quantized(self, weight_dtype: torch.dtype = torch.bfloat16,
                          qcfg=None, step: Optional[int] = None,
                          use_pallas: Optional[bool] = None, *,
                          device: DeviceLike = "cuda", keep=_keep_all):
        """-> (quantized tree, QuantConfig) from either checkpoint kind.

        A ``save_quantized`` checkpoint restores codes and scales as they
        are under its saved config (an explicit ``qcfg`` must agree with it
        except for ``use_pallas``, which the loader picks); a plain float
        checkpoint is restored and quantized on load with ``qcfg`` (default
        int8). ``weight_dtype`` is the logical dtype of the float weights
        the codes stand for (JAX reads it from an abstract base tree).
        ``keep(path, leaf)`` takes each restored leaf (a QuantTensor whole)
        as in ``restore``; it is refused for a float checkpoint, whose
        quantization needs the whole weights."""
        from repro_torch import quant
        d, index = self._step_dir(step)
        ex = index.get("extra", {})
        if ex.get("kind") == "quantized_params":
            saved = dict(ex["quant"])
            saved["target_patterns"] = tuple(saved.get("target_patterns", ()))
            saved_cfg = quant.QuantConfig(**saved)
            if qcfg is not None:
                used_cfg = dataclasses.replace(saved_cfg,
                                               use_pallas=qcfg.use_pallas)
                if qcfg != used_cfg:
                    raise ValueError(
                        f"checkpoint was quantized with {saved_cfg}, which "
                        f"conflicts with the requested {qcfg} — re-quantize "
                        "from a float checkpoint to change modes")
            elif use_pallas is not None:
                used_cfg = dataclasses.replace(saved_cfg,
                                               use_pallas=use_pallas)
            else:
                used_cfg = saved_cfg
            meta = QuantMeta(mode=used_cfg.mode,
                             dtype=dtype_name(weight_dtype),
                             axis=used_cfg.axis,
                             use_pallas=used_cfg.use_pallas)
            dev = resolve_device(device)
            return _quant_nodes(
                _nest({k: k for k in index["leaves"]}), meta,
                lambda k: _load_leaf(os.path.join(d, k + ".npy"),
                                     index["leaves"][k]["dtype"], dev),
                keep), used_cfg
        if keep is not _keep_all:
            raise ValueError("a float checkpoint is quantized whole on "
                             "load: restore it with restore(keep=) and "
                             "quantize the kept leaves")
        qcfg = qcfg or quant.QuantConfig(use_pallas=bool(use_pallas))
        params = _nest(self._load(d, index, resolve_device(device)))
        return quant.quantize_params(params, qcfg), qcfg

    # -- named adapter banks --------------------------------------------------
    def save_adapters(self, step: int,
                      adapters_by_name: Dict[str, Dict[str, Dict[str, Any]]],
                      peft_cfg, blocking: bool = True) -> None:
        """Save named adapters {name: {weight_path: {param: tensor}}} plus
        their PEFTConfig(s) as index metadata, the serving bank format.
        ``peft_cfg`` is one PEFTConfig or a {name: PEFTConfig} mapping; the
        index records each adapter's method and full config
        (``peft_by_name``)."""
        from repro_torch.core.peft import normalize_bank_cfgs
        primary, cfg_by_name = normalize_bank_cfgs(adapters_by_name, peft_cfg)
        extra = {
            "kind": "adapter_bank",
            "peft": dataclasses.asdict(primary),
            "peft_by_name": {name: dataclasses.asdict(c)
                             for name, c in cfg_by_name.items()},
            "adapter_methods": {name: c.method
                                for name, c in cfg_by_name.items()},
            "adapter_names": list(adapters_by_name),
            "weight_paths": sorted({p for ad in adapters_by_name.values()
                                    for p in ad}),
        }
        self.save(step, dict(adapters_by_name), blocking=blocking,
                  extra=extra)

    def _adapter_ckpt(self, step: Optional[int]):
        """-> (ckpt dir, index, extra) of an adapter-bank checkpoint."""
        d, index = self._step_dir(step)
        ex = index.get("extra", {})
        if ex.get("kind") != "adapter_bank":
            raise ValueError(f"{d} is not an adapter-bank checkpoint "
                             f"(kind={ex.get('kind')!r})")
        return d, index, ex

    @staticmethod
    def _adapter_tree(name: str, weight_paths, flat) -> Dict[str, Any]:
        tree: Dict[str, Dict[str, Any]] = {}
        for path in weight_paths:
            prefix = f"{name}{_SEP}{path.replace('/', _SEP)}{_SEP}"
            entry = {k[len(prefix):]: v for k, v in flat.items()
                     if k.startswith(prefix)}
            if entry:
                tree[path] = entry
        return tree

    @staticmethod
    def _cfgs(ex: Dict) -> Tuple[Tuple[str, ...], Dict[str, Any]]:
        primary = _peft_cfg(ex["peft"])
        by_name = {n: _peft_cfg(c) for n, c in
                   ex.get("peft_by_name", {}).items()}
        names = tuple(ex["adapter_names"])
        return names, {n: by_name.get(n, primary) for n in names}

    def restore_adapters(self, step: Optional[int] = None, *,
                         device: DeviceLike = "cuda"
                         ) -> Tuple[Dict[str, Dict[str, Dict[str, Any]]],
                                    Dict[str, Any]]:
        """-> (adapters_by_name, {name: PEFTConfig}) of a ``save_adapters``
        checkpoint, from the index alone (a checkpoint with one shared
        ``peft`` record maps every name to it)."""
        d, index, ex = self._adapter_ckpt(step)
        names, cfgs = self._cfgs(ex)
        flat = self._load(d, index, resolve_device(device))
        return ({n: self._adapter_tree(n, ex["weight_paths"], flat)
                 for n in names}, cfgs)

    def adapter_index(self, step: Optional[int] = None
                      ) -> Tuple[Tuple[str, ...], Dict[str, Any],
                                 Tuple[str, ...]]:
        """-> (names, {name: PEFTConfig}, weight_paths) from the index
        alone: no adapter leaf is read."""
        _, _, ex = self._adapter_ckpt(step)
        names, cfgs = self._cfgs(ex)
        return names, cfgs, tuple(ex["weight_paths"])

    def load_adapter(self, name: str, step: Optional[int] = None, *,
                     device: DeviceLike = "cuda"
                     ) -> Dict[str, Dict[str, Any]]:
        """Load ONE named adapter's tree, reading only its own leaves."""
        d, index, ex = self._adapter_ckpt(step)
        if name not in ex["adapter_names"]:
            raise KeyError(f"{d} has adapters {ex['adapter_names']}, "
                           f"not {name!r}")
        mine = f"{name}{_SEP}"
        flat = self._load(d, index, resolve_device(device),
                          only=lambda k: k.startswith(mine))
        return self._adapter_tree(name, ex["weight_paths"], flat)
