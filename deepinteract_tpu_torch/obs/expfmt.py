"""Prometheus text exposition (format 0.0.4) of the metrics registry, and
the per-worker relabel and merge the fleet router applies to its workers'
scrapes.

Port of ``deepinteract_tpu/obs/expfmt.py`` plus the exposition helpers of
``deepinteract_tpu/serving/router.py`` (stdlib only, so the port keeps its
own copy). One renderer serves the engine server, the fleet router and
the stub worker: every ``GET /metrics`` of the port is :func:`render`.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Tuple

from deepinteract_tpu_torch.obs.metrics import MetricsRegistry, get_registry

# The content type Prometheus scrapers negotiate for the text format.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(.+)$")


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(text: str) -> str:
    return (text.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _fmt_value(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def render(registry: Optional[MetricsRegistry] = None) -> str:
    """The whole registry as Prometheus text; deterministic ordering
    (families by name, series by label values) so scrapes diff cleanly."""
    reg = registry if registry is not None else get_registry()
    lines = []
    for fam in reg.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for suffix, labels, value in fam.samples():
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in labels.items())
                lines.append(
                    f"{fam.name}{suffix}{{{body}}} {_fmt_value(value)}")
            else:
                lines.append(f"{fam.name}{suffix} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def inject_label(line: str, worker_id: str) -> str:
    """``name{a="b"} 1`` -> ``name{worker="wN",a="b"} 1`` (and the
    label-less form grows the braces). Non-matching lines pass through
    untouched."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return line
    name, _, inner, value = m.groups()
    label = f'worker="{worker_id}"'
    inner = f"{label},{inner}" if inner else label
    return f"{name}{{{inner}}} {value}"


def family_of(sample_name: str) -> str:
    """Histogram series (_bucket/_sum/_count) group under their base
    family for HELP/TYPE purposes."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


def parse_exposition(text: str, relabel: Optional[str] = None) -> Dict[str, Dict]:
    """Exposition text -> ordered {family: {help, type, samples}}. With
    ``relabel``, a ``worker`` label is injected into every sample of a
    ``di_*`` family (the repo's own namespace; foreign families pass
    through unlabeled)."""
    families: Dict[str, Dict] = {}

    def fam(name: str) -> Dict:
        return families.setdefault(name, {"help": None, "type": None, "samples": []})

    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            fam(name)["help"] = help_text
        elif line.startswith("# TYPE "):
            name, _, type_text = line[len("# TYPE "):].partition(" ")
            fam(name)["type"] = type_text
        elif line.strip() and not line.startswith("#"):
            m = _SAMPLE_RE.match(line)
            name = family_of(m.group(1)) if m else line.split()[0]
            if relabel is not None and name.startswith("di_"):
                line = inject_label(line, relabel)
            fam(name)["samples"].append(line)
    return families


def merge(own: str, workers: Iterable[Tuple[str, str]]) -> str:
    """``own`` exposition plus each ``(worker_id, text)`` relabeled with
    ``worker="wN"``, merged into one block per family (one HELP and one
    TYPE each), so the combined scrape stays valid Prometheus text."""
    families = parse_exposition(own)
    for worker_id, text in workers:
        for name, fam in parse_exposition(text, relabel=worker_id).items():
            mine = families.setdefault(
                name, {"help": fam["help"], "type": fam["type"], "samples": []})
            mine["samples"].extend(fam["samples"])
    out: List[str] = []
    for name, fam in families.items():
        if fam["help"] is not None:
            out.append(f"# HELP {name} {fam['help']}")
        if fam["type"] is not None:
            out.append(f"# TYPE {name} {fam['type']}")
        out.extend(fam["samples"])
    return "\n".join(out) + "\n"
