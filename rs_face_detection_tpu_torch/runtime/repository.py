"""Triton-style model repository on disk: config.pbtxt + versioned weights.

The port's copy of rs_face_detection_tpu/runtime/repository.py.  A model
repository is a directory tree of

    <repository>/
      <model_name>/
        config.pbtxt          # text-format inference.ModelConfig
        1/model.npz           # numeric version dirs, highest wins
        2/model.npz

Weights are the self-describing .npz checkpoints of
models/checkpoint_io.py (the JAX package's format: flax paths plus an
embedded meta that names the architecture, the role Triton's backend field
plays), so a repository either package wrote serves from the other
unchanged.  `config.pbtxt` is parsed with a small protobuf *text-format*
reader so existing Triton-tooling habits (editing max_batch_size,
inspecting dims) carry over.

    registry = ModelRegistry()                 # the card; ModelRegistry("cpu")
    attach_repository_builders(registry, "/models")
    serve(None, registry)                      # runtime/server.py

The text-format subset understood here covers what model repositories use
in practice: scalar fields (`key: value` with string/number/bool/enum
values), message fields (`key { ... }`, colon optional), repeated fields
by key repetition, and bracket lists of scalars or messages
(`dims: [1, 3, 640, 640]`, `input [ { ... }, { ... } ]`).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "parse_pbtxt",
    "scan_repository",
    "attach_repository_builders",
    "write_repository_entry",
    "RepositoryModel",
    "EnsembleDefinition",
    "EnsembleStep",
]


# ---------------------------------------------------------------------------
# protobuf text-format (subset) parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s+                                   # whitespace (skipped)
  | \#[^\n]*                              # comment (skipped)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')  # quoted string
  | (?P<punct>[{}\[\]:,;])                # structure (; is a separator)
  | (?P<scalar>[^\s{}\[\]:,;"'#]+)        # number / bool / enum / ident
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(
                f"config.pbtxt: cannot tokenize at offset {pos}: "
                f"{text[pos:pos + 20]!r}"
            )
        pos = m.end()
        if m.lastgroup == "string":
            tokens.append(("string", m.group("string")))
        elif m.lastgroup == "punct":
            tokens.append(("punct", m.group("punct")))
        elif m.lastgroup == "scalar":
            tokens.append(("scalar", m.group("scalar")))
        # whitespace/comments fall through
    return tokens


def _scalar_value(tok: str) -> Any:
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum / identifier, kept as string


_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'",
    "a": "\a", "b": "\b", "f": "\f", "v": "\v", "0": "\0",
}


def _unquote(tok: str) -> str:
    """Resolve backslash escapes without mangling non-ASCII text (a
    unicode_escape round trip would mojibake UTF-8 model names)."""
    return re.sub(
        r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(1)), tok[1:-1]
    )


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def _peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def _next(self) -> Tuple[str, str]:
        tok = self._peek()
        if tok is None:
            raise ValueError("config.pbtxt: unexpected end of input")
        self.i += 1
        return tok

    def _expect(self, value: str) -> None:
        kind, tok = self._next()
        if kind != "punct" or tok != value:
            raise ValueError(f"config.pbtxt: expected {value!r}, got {tok!r}")

    def message(self, *, top_level: bool = False) -> Dict[str, Any]:
        """Parse fields until '}' (or end of input at top level).  Repeated
        keys accumulate into lists; single occurrences stay scalar."""
        msg: Dict[str, Any] = {}
        while True:
            tok = self._peek()
            if tok is None:
                if top_level:
                    return msg
                raise ValueError("config.pbtxt: unterminated message")
            if tok == ("punct", "}"):
                if top_level:
                    raise ValueError("config.pbtxt: unmatched '}'")
                self.i += 1
                return msg
            if tok[0] == "punct" and tok[1] in (",", ";"):  # separators
                self.i += 1
                continue
            kind, key = self._next()
            if kind != "scalar":
                raise ValueError(f"config.pbtxt: expected field name, got {key!r}")
            values = self._field_value()
            for v in values:
                if key in msg:
                    if not isinstance(msg[key], list):
                        msg[key] = [msg[key]]
                    msg[key].append(v)
                else:
                    msg[key] = v

    def _field_value(self) -> List[Any]:
        """Values for one field occurrence (a bracket list yields several)."""
        tok = self._peek()
        if tok == ("punct", ":"):
            self.i += 1
            tok = self._peek()
        if tok is None:
            raise ValueError("config.pbtxt: field without a value")
        kind, val = tok
        if tok == ("punct", "{"):
            self.i += 1
            return [self.message()]
        if tok == ("punct", "["):
            self.i += 1
            out: List[Any] = []
            while True:
                tok = self._peek()
                if tok is None:
                    raise ValueError("config.pbtxt: unterminated list")
                if tok == ("punct", "]"):
                    self.i += 1
                    return out
                if tok == ("punct", ","):
                    self.i += 1
                    continue
                if tok == ("punct", "{"):
                    self.i += 1
                    out.append(self.message())
                    continue
                kind, val = self._next()
                out.append(
                    _unquote(val) if kind == "string" else _scalar_value(val)
                )
        if kind == "string":
            self.i += 1
            # adjacent string literals concatenate (proto text format)
            parts = [_unquote(val)]
            while self._peek() is not None and self._peek()[0] == "string":
                parts.append(_unquote(self._next()[1]))
            return ["".join(parts)]
        if kind == "scalar":
            self.i += 1
            return [_scalar_value(val)]
        raise ValueError(f"config.pbtxt: unexpected token {val!r}")


def parse_pbtxt(text: str) -> Dict[str, Any]:
    """Parse protobuf text format (the subset above) into plain dicts.

    Repeated fields appear as lists when they occur more than once or use
    bracket-list syntax; use `as_list` to normalize.
    """
    return _Parser(_tokenize(text)).message(top_level=True)


def as_list(value: Any) -> List[Any]:
    """Normalize a possibly-singular parsed field to a list."""
    if value is None:
        return []
    return value if isinstance(value, list) else [value]


# ---------------------------------------------------------------------------
# ensemble scheduling (model_config.proto: ModelEnsembling, :1548-1607; the
# `ensemble_scheduling = 15` member of ModelConfig's scheduling_choice oneof,
# :1936).  Triton's ensemble "platform" is a dataflow DAG over other models:
# each step maps ensemble-scope tensor names onto one member model's input
# and output tensors; a request against the ensemble runs the steps in
# dependency order and returns the declared ensemble outputs.  The
# production pipelines (pipeline/face_pipeline.py) chain their stages on the
# device themselves; the ensemble exists for Triton-workflow parity, routing
# between the same member modules the wire serves individually.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EnsembleStep:
    """One `ensemble_scheduling.step` entry.

    input_map:  member-model input tensor name  -> ensemble tensor name
    output_map: member-model output tensor name -> ensemble tensor name
    (model_config.proto:1562-1589; model_version -1 = latest)
    """

    model_name: str
    model_version: int
    input_map: Tuple[Tuple[str, str], ...]
    output_map: Tuple[Tuple[str, str], ...]


@dataclass
class EnsembleDefinition:
    """A validated `platform: "ensemble"` model.

    Stored in the registry as the entry's `module`; it has no weights and
    cannot be applied directly — the wire/HTTP ModelInfer verb recognizes
    it and runs the member dataflow instead (runtime/wire.py).
    `steps` is already in dependency (topological) order.
    """

    name: str
    inputs: List[Dict[str, Any]]  # declared config inputs (name/dims/...)
    outputs: List[Dict[str, Any]]
    steps: List[EnsembleStep]
    max_batch_size: int = 0

    def apply(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"ensemble {self.name!r} has no weights to apply; serve it "
            "through ModelInfer (wire/HTTP), which routes between its "
            "member models"
        )


def _string_map(field_value: Any, where: str) -> Dict[str, str]:
    """Normalize a parsed text-format map<string,string> (repeated
    `{ key: ... value: ... }` entries) into a dict."""
    out: Dict[str, str] = {}
    for entry in as_list(field_value):
        if (
            not isinstance(entry, dict)
            or "key" not in entry
            or "value" not in entry
        ):
            raise ValueError(f"{where}: map entry must have key and value")
        k, v = str(entry["key"]), str(entry["value"])
        if k in out:
            raise ValueError(f"{where}: duplicate map key {k!r}")
        out[k] = v
    return out


def _tensor_names(specs: List[Dict[str, Any]], where: str) -> List[str]:
    names = []
    for spec in specs:
        if not isinstance(spec, dict) or not spec.get("name"):
            raise ValueError(f"{where}: tensor entries must carry a name")
        names.append(str(spec["name"]))
    if len(set(names)) != len(names):
        raise ValueError(f"{where}: duplicate tensor names {names}")
    return names


def parse_ensemble(name: str, config: Dict[str, Any]) -> EnsembleDefinition:
    """Validate an ensemble config and return its definition with steps in
    dependency order.

    Static checks mirror what Triton enforces at model load: every step
    schedulable from the ensemble inputs (no cycles, no dangling tensor),
    each ensemble-scope tensor produced at most once (and never shadowing
    an ensemble input), and every declared ensemble output produced by some
    step.
    """
    where = f"ensemble {name!r}"
    sched = config.get("ensemble_scheduling")
    if not isinstance(sched, dict):
        raise ValueError(f"{where}: missing ensemble_scheduling block")
    raw_steps = as_list(sched.get("step"))
    if not raw_steps:
        raise ValueError(f"{where}: ensemble_scheduling has no steps")
    inputs = [s for s in as_list(config.get("input")) if isinstance(s, dict)]
    outputs = [s for s in as_list(config.get("output")) if isinstance(s, dict)]
    input_names = _tensor_names(inputs, f"{where} input")
    output_names = _tensor_names(outputs, f"{where} output")
    if not input_names or not output_names:
        raise ValueError(f"{where}: must declare input and output tensors")

    steps: List[EnsembleStep] = []
    for i, raw in enumerate(raw_steps):
        swhere = f"{where} step {i}"
        if not isinstance(raw, dict) or not raw.get("model_name"):
            raise ValueError(f"{swhere}: missing model_name")
        imap = _string_map(raw.get("input_map"), f"{swhere} input_map")
        omap = _string_map(raw.get("output_map"), f"{swhere} output_map")
        if not imap or not omap:
            raise ValueError(
                f"{swhere}: input_map and output_map are required"
            )
        if len(imap) != 1:
            # Triton rejects unsatisfiable ensembles at model load, not per
            # request; member models served here take exactly one input
            # tensor, so a multi-entry input_map can never be scheduled.
            raise ValueError(
                f"{swhere}: member models take exactly one input tensor; "
                f"input_map has {len(imap)} entries"
            )
        steps.append(
            EnsembleStep(
                model_name=str(raw["model_name"]),
                model_version=int(raw.get("model_version", -1)),
                input_map=tuple(sorted(imap.items())),
                output_map=tuple(sorted(omap.items())),
            )
        )

    # each ensemble tensor has exactly one producer
    produced: Dict[str, int] = {}
    for i, step in enumerate(steps):
        for _, ens_name in step.output_map:
            if ens_name in input_names:
                raise ValueError(
                    f"{where} step {i}: output tensor {ens_name!r} shadows "
                    "an ensemble input"
                )
            if ens_name in produced:
                raise ValueError(
                    f"{where}: tensor {ens_name!r} produced by both step "
                    f"{produced[ens_name]} and step {i}"
                )
            produced[ens_name] = i

    # topological order by simulation from the ensemble inputs
    available = set(input_names)
    ordered: List[EnsembleStep] = []
    pending = list(enumerate(steps))
    while pending:
        progressed = False
        still = []
        for i, step in pending:
            needs = [v for _, v in step.input_map]
            if all(n in available for n in needs):
                ordered.append(step)
                available.update(v for _, v in step.output_map)
                progressed = True
            else:
                still.append((i, step))
        if not progressed:
            missing = sorted(
                {
                    v
                    for _, step in still
                    for _, v in step.input_map
                    if v not in available
                }
            )
            raise ValueError(
                f"{where}: steps {[i for i, _ in still]} are not "
                f"schedulable — tensor(s) {missing} are never produced "
                "(cycle or missing producer)"
            )
        pending = still

    unproduced = [n for n in output_names if n not in available]
    if unproduced:
        raise ValueError(
            f"{where}: declared output(s) {unproduced} are not produced "
            "by any step"
        )
    return EnsembleDefinition(
        name=name,
        inputs=inputs,
        outputs=outputs,
        steps=ordered,
        max_batch_size=int(config.get("max_batch_size", 0)),
    )


# ---------------------------------------------------------------------------
# repository scan
# ---------------------------------------------------------------------------


@dataclass
class RepositoryModel:
    """One scanned `<repository>/<name>` entry."""

    name: str
    path: str  # model directory
    version: int
    weights_path: str
    config: Dict[str, Any] = field(default_factory=dict)


def _version_dirs(model_dir: str) -> List[int]:
    out = []
    for entry in os.listdir(model_dir):
        if entry.isdigit() and os.path.isdir(os.path.join(model_dir, entry)):
            out.append(int(entry))
    return sorted(out)


#: config.pbtxt fields this loader reads as SINGULAR — a duplicate (which
#: protoc's text parser rejects for non-repeated fields) parses into a list
#: and must be diagnosed at scan time, not as a TypeError at load time.
_SINGULAR_FIELDS = ("name", "max_batch_size", "default_model_filename")


def _scan_one(root: str, entry: str) -> Optional[RepositoryModel]:
    model_dir = os.path.join(root, entry)
    cfg_path = os.path.join(model_dir, "config.pbtxt")
    config: Dict[str, Any] = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = parse_pbtxt(f.read())
    for key in _SINGULAR_FIELDS:
        if isinstance(config.get(key), list):
            raise ValueError(
                f"{cfg_path}: field {key!r} appears more than once "
                f"(it is singular in model_config.proto)"
            )
    cfg_name = config.get("name", entry)
    if cfg_name != entry:
        raise ValueError(
            f"{cfg_path}: name {cfg_name!r} does not match the model "
            f"directory {entry!r} (Triton requires them equal)"
        )
    filename = config.get("default_model_filename", "model.npz")
    versions = _version_dirs(model_dir)
    if config.get("platform") == "ensemble":
        parse_ensemble(entry, config)  # surface malformed DAGs at scan time
        # Ensembles have no weights; Triton still keeps a (possibly empty)
        # numeric version dir, so the highest one names the served version.
        return RepositoryModel(
            name=entry,
            path=model_dir,
            version=versions[-1] if versions else 1,
            weights_path="",
            config=config,
        )
    for v in reversed(versions):
        candidate = os.path.join(model_dir, str(v), filename)
        if os.path.exists(candidate):
            return RepositoryModel(
                name=entry,
                path=model_dir,
                version=v,
                weights_path=candidate,
                config=config,
            )
    return None  # not a servable model dir (no weights) — skip quietly


def scan_repository(
    root: str, errors: Optional[List[Tuple[str, str]]] = None
) -> List[RepositoryModel]:
    """Scan a repository tree; returns one entry per valid model directory.

    Triton semantics preserved: the model name is the directory name, and a
    `name` field inside config.pbtxt must match it (Triton refuses the
    mismatch too); the served version is the highest numeric subdirectory
    that contains the weights file (`default_model_filename`, default
    `model.npz`).

    errors: when given, a malformed model directory is recorded there as
    (name, message) and the scan continues — Triton likewise marks the
    broken model UNAVAILABLE and serves the rest; when None, the first
    malformed entry raises.
    """
    if not os.path.isdir(root):
        raise ValueError(f"model repository {root!r} is not a directory")
    models: List[RepositoryModel] = []
    for entry in sorted(os.listdir(root)):
        if not os.path.isdir(os.path.join(root, entry)):
            continue
        try:
            scanned = _scan_one(root, entry)
        except ValueError as e:
            if errors is None:
                raise
            errors.append((entry, str(e)))
            continue
        if scanned is not None:
            models.append(scanned)
    return models


# ---------------------------------------------------------------------------
# spec derivation + config validation
# ---------------------------------------------------------------------------

def _family_output() -> Dict[str, Tuple[str, str]]:
    """(output_spec, preprocessing note) per checkpoint family.  The
    detection contract string is imported from the registry so the two
    serving surfaces cannot drift."""
    from ..models.registry import DETECTION_OUTPUT_SPEC

    return {
        "retinaface": (DETECTION_OUTPUT_SPEC, "letterbox, BGR->RGB, raw 0-255"),
        "scrfd": (
            "per-stride score/bbox/landmark maps",
            "letterbox, BGR->RGB, (px-127.5)/128",
        ),
        "iresnet": ("embedding", "BGR->RGB, (px-127.5)*0.0078125"),
        "minifas": ("logits", "raw 0-255, channel-reversed"),
        "resnet18": ("logits", "BGR->RGB, (px-mean)*std"),
        "clip_vit": ("logits", "BGR->RGB, ImageNet mean/std"),
    }


def _input_shape_from_meta(meta: Dict[str, Any]) -> Tuple[int, int, int]:
    if "input_hw" in meta:  # minifas stores (h, w)
        h, w = meta["input_hw"]
        return (int(h), int(w), 3)
    w, h = meta["image_size"]  # others store (w, h)
    return (int(h), int(w), 3)


def _dims_compatible(
    dims: List[int], hwc: Tuple[int, int, int], max_batch_size: int
) -> bool:
    """Do config.pbtxt input dims describe this model's (H, W, C)?

    Accepts CHW / HWC with -1 wildcards.  Triton's batch-dim convention is
    enforced: when max_batch_size > 0 the dims must OMIT the batch dim
    (3 entries); only max_batch_size == 0 carries it explicitly (4 entries,
    also accepted as 3 for batchless models) — a config Triton would
    reject must not validate here either.
    """
    h, w, c = hwc
    dims = [int(d) for d in dims]
    if len(dims) == 4:
        if max_batch_size > 0:
            return False  # batch dim must be omitted when batching is on
        dims = dims[1:]
    if len(dims) != 3:
        return False

    def match(got: List[int], want: Tuple[int, int, int]) -> bool:
        return all(g == -1 or g == t for g, t in zip(got, want))

    return match(dims, (c, h, w)) or match(dims, (h, w, c))


def _validate_config(
    model: RepositoryModel, input_shape: Tuple[int, int, int]
) -> None:
    max_batch_size = int(model.config.get("max_batch_size", 0))
    inputs = as_list(model.config.get("input"))
    for spec in inputs:
        dims = spec.get("dims")
        if dims is None:
            continue
        dims = as_list(dims)
        if not _dims_compatible(dims, input_shape, max_batch_size):
            raise ValueError(
                f"{model.path}/config.pbtxt: input dims {dims} do not "
                f"describe the checkpoint's input shape {input_shape} "
                f"(HWC, from the .npz meta) under "
                f"max_batch_size={max_batch_size} (Triton omits the batch "
                f"dim when max_batch_size > 0)"
            )
        dt = spec.get("data_type")
        if dt not in (None, "TYPE_FP32"):
            raise ValueError(
                f"{model.path}/config.pbtxt: data_type {dt} unsupported "
                f"(the serving surface is fp32, like the reference's "
                f"fp32_contents requests)"
            )


# ---------------------------------------------------------------------------
# registry attachment
# ---------------------------------------------------------------------------


def _dynamic_batching_config(config: Dict[str, Any]) -> Tuple[bool, int]:
    """config.pbtxt `dynamic_batching {...}` -> (enabled, max_queue_delay_us).

    Presence of the block enables the scheduler (Triton semantics,
    model_config.proto:1104) — an EMPTY `dynamic_batching {}` block parses
    to an empty dict, so test presence, not truthiness."""
    db = config.get("dynamic_batching")
    if db is None:
        return False, 0
    delay = 0
    if isinstance(db, dict):
        delay = int(db.get("max_queue_delay_microseconds", 0) or 0)
    return True, delay


def _warn_unhonored_scheduling(name: str, config: Dict[str, Any]) -> None:
    """Warn once per scan for Triton scheduling config this server parses
    but does not act on — an operator porting a repository must hear about
    silently-different behavior."""
    import logging

    log = logging.getLogger(__name__)
    if config.get("sequence_batching") is not None:
        log.warning(
            "model %r: sequence_batching is not honored (stateless serving "
            "only); requests are scheduled independently",
            name,
        )
    for group in as_list(config.get("instance_group")):
        if isinstance(group, dict) and int(group.get("count", 1) or 1) > 1:
            log.warning(
                "model %r: instance_group count=%s is not honored — one "
                "module on the registry's device serves all requests",
                name,
                group.get("count"),
            )
    db = config.get("dynamic_batching")
    if isinstance(db, dict):
        unhonored = sorted(
            set(db) - {"max_queue_delay_microseconds", "preferred_batch_size"}
        )
        if unhonored:
            log.warning(
                "model %r: dynamic_batching field(s) %s are not honored "
                "(supported: max_queue_delay_microseconds; batches pad to "
                "max_batch_size so preferred_batch_size is moot)",
                name,
                unhonored,
            )


def attach_repository_builders(registry, root: str) -> List[str]:
    """Register a lazy builder per repository model; returns the names.

    Each builder loads the picked version's .npz with
    checkpoint_io.load_imported_model (architecture from embedded meta; the
    registry moves the module to its device), validates config.pbtxt
    dims/data_type against it, and derives the ModelSpec Triton would
    synthesize from the config.  An ensemble's builder returns its
    EnsembleDefinition, which the registry holds as it is.

    A malformed model directory does NOT abort the scan: like Triton, the
    broken model is still registered (so repository_index lists it) with a
    builder that raises its scan error on load — every other model serves
    normally.
    """
    from ..models.registry import ModelSpec

    errors: List[Tuple[str, str]] = []
    models = scan_repository(root, errors=errors)

    def make_failing_builder(name: str, message: str):
        def builder():
            raise ValueError(message)

        return builder

    def make_ensemble_builder(m: RepositoryModel):
        def builder():
            from ..models.registry import ModelSpec

            defn = parse_ensemble(m.name, m.config)
            # Triton verifies composing models at ensemble load: an
            # ensemble naming an unknown member is UNAVAILABLE, not a
            # per-request NOT_FOUND (model_repository_manager semantics).
            known = {e["name"] for e in registry.index()}
            unknown = sorted(
                {s.model_name for s in defn.steps} - known
            )
            if unknown:
                raise ValueError(
                    f"ensemble {m.name!r}: member model(s) {unknown} "
                    "are not registered"
                )
            # cosmetic spec shape: first declared input, NCHW like the wire
            dims = [int(d) for d in as_list(defn.inputs[0].get("dims"))]
            if len(dims) == 4:
                dims = dims[1:]
            if len(dims) == 3:
                input_shape = (dims[1], dims[2], dims[0])  # CHW -> HWC
            else:
                input_shape = (-1, -1, -1)
            members = [s.model_name for s in defn.steps]
            spec = ModelSpec(
                name=m.name,
                input_shape=input_shape,
                output_spec="ensemble: "
                + ", ".join(str(o.get("name")) for o in defn.outputs),
                max_batch_size=defn.max_batch_size or 1,
                preprocessing=f"dataflow over {members}",
            )
            return spec, defn

        return builder

    def make_builder(m: RepositoryModel):
        def builder():
            from ..models.checkpoint_io import load_imported_model

            model_obj, meta = load_imported_model(m.weights_path, return_meta=True)
            input_shape = _input_shape_from_meta(meta)
            _validate_config(m, input_shape)
            family = meta.get("family", "?")
            output_spec, preprocessing = _family_output().get(
                family, ("unknown", "unknown")
            )
            if family == "iresnet":
                output_spec = f"(B, {meta['embedding_dim']}) embedding"
            dyn, delay_us = _dynamic_batching_config(m.config)
            spec = ModelSpec(
                name=m.name,
                input_shape=input_shape,
                output_spec=output_spec,
                max_batch_size=int(m.config.get("max_batch_size", 0)) or 1,
                preprocessing=preprocessing,
                dynamic_batching=dyn,
                max_queue_delay_us=delay_us,
            )
            return spec, model_obj

        return builder

    for m in models:
        _warn_unhonored_scheduling(m.name, m.config)
        if m.config.get("platform") == "ensemble":
            registry.register_builder(m.name, make_ensemble_builder(m))
        else:
            registry.register_builder(m.name, make_builder(m))
    for name, message in errors:
        registry.register_builder(name, make_failing_builder(name, message))
    return [m.name for m in models] + [name for name, _ in errors]


# ---------------------------------------------------------------------------
# repository writer
# ---------------------------------------------------------------------------


def _render_pbtxt(
    name: str, input_shape: Tuple[int, int, int], max_batch_size: int
) -> str:
    h, w, c = input_shape
    return (
        f'name: "{name}"\n'
        f'backend: "rs_face_detection_tpu_torch"\n'
        f"max_batch_size: {max_batch_size}\n"
        "input [\n"
        "  {\n"
        '    name: "data"\n'
        "    data_type: TYPE_FP32\n"
        f"    dims: [ {c}, {h}, {w} ]\n"
        "  }\n"
        "]\n"
        "output [\n"
        "  {\n"
        '    name: "output"\n'
        "    data_type: TYPE_FP32\n"
        "    dims: [ -1 ]\n"
        "  }\n"
        "]\n"
    )


def write_repository_entry(
    root: str,
    name: str,
    model: Any,
    meta: Dict[str, Any],
    version: int = 1,
    max_batch_size: int = 1,
) -> str:
    """Write `<root>/<name>/config.pbtxt` + `<root>/<name>/<version>/model.npz`.

    ``model``: a float nn.Module of the family ``meta`` names; its weights
    are written as the JAX package's flax paths (checkpoint_io.save_imported),
    so the entry serves from either package.

    Returns the weights path.  The generated config round-trips through
    parse_pbtxt/scan_repository and matches what _validate_config expects.
    An EXISTING config.pbtxt is left untouched — publishing a new version
    into an entry whose config an operator has hand-tuned (max_batch_size
    etc.) must not revert those edits.
    """
    from ..models.checkpoint_io import save_imported

    model_dir = os.path.join(root, name)
    version_dir = os.path.join(model_dir, str(version))
    os.makedirs(version_dir, exist_ok=True)
    input_shape = _input_shape_from_meta(dict(meta))
    cfg_path = os.path.join(model_dir, "config.pbtxt")
    if not os.path.exists(cfg_path):
        with open(cfg_path, "w") as f:
            f.write(_render_pbtxt(name, input_shape, max_batch_size))
    weights_path = os.path.join(version_dir, "model.npz")
    save_imported(weights_path, model, meta)
    return weights_path
