"""Artifact fsck: verify/quarantine/report over a run directory.

Port of ``deepinteract_tpu/cli/fsck.py`` over the port's artifacts.
``python -m deepinteract_tpu_torch.cli.fsck RUNDIR`` walks everything a run
persists: checkpoint steps (``best/``, ``last/``, ``mid/`` of
training/checkpoint.py: the ``state.pt`` payload, the
``_CHECKPOINT_METADATA`` commit marker, the tree integrity sidecar), the
``trainer_state.json`` cursor, heartbeats, supervisor and fleet state with
the fleet's agreement ledgers, proteome-index manifests and shards,
calibrations, assembly bundles and maps, embedding-cache npz spills and
screen manifests, and checks bytes on disk against the
``*.integrity.json`` sidecars that robustness/artifacts.py writes (the
JAX package's schema, so each package's fsck reads the other's trees):

* **verified**: sidecar present, byte length and SHA-256 match;
* **corrupt**: truncation, bit flip, unreadable sidecar, a torn
  checkpoint step (``_CHECKPOINT_METADATA`` missing), or a structurally
  damaged record. With ``--quarantine`` these are moved aside as
  ``<name>.corrupt-<ts>`` so the owning subsystem's next run recovers;
* **unverified**: a known artifact with no sidecar (a sidecar-less
  writer such as the supervisors' state files); JSON artifacts get a
  parse check;
* **orphans**: ``*.tmp`` strays from killed writers (removed with
  ``--sweep_tmp`` or ``--quarantine``) and sidecars whose target is gone.

Nothing here touches a device. Exit codes: 0 = clean, or every
corruption was quarantined this run (recovery complete); 1 = corruption
present and left in place; 2 = bad invocation. The FINAL stdout line is
the machine-readable ``fsck/v1`` contract (tools/check_cli_contract.py
kind ``fsck``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

from deepinteract_tpu_torch.robustness import artifacts

# Sidecar-less files fsck still recognizes and JSON-parse-checks: the
# ones the port writes (the JAX list also names its tuning store, which
# the port does not have). Supervisor state files
# (training/supervisor.py, serving/fleet.py) are atomic-but-sidecar-less
# by design: their value is freshness, and a torn write is impossible
# (os.replace), so a parse failure here means bit rot — flagged.
KNOWN_UNVERIFIED_BASENAMES = ("trainer_state.json", "train_supervisor_state.json",
                              "fleet_state.json")

# A heartbeat this old is reported stale (obs/heartbeat.read_heartbeat
# does the math — shared with the fleet supervisor's liveness check).
HEARTBEAT_MAX_AGE_S = 300.0

# Proteome-index artifacts (index/format.py — the names are duplicated
# here so fsck stays importable without pulling the engine stack). Shards
# REQUIRE a sidecar: every writer goes through atomic_write_artifact, so a
# naked shard is a stray.
INDEX_MANIFEST_BASENAME = "index_manifest.json"
INDEX_SHARD_PREFIX = "part-"

# Calibration artifacts (calibration/calibrator.py) and
# assembly bundles (cli/assemble.py). All three writers go through
# atomic_write_artifact, so a naked file is a stray — sidecar REQUIRED.
CALIBRATION_BASENAME = "calibration.json"
CALIBRATION_SUFFIX = ".calibration.json"
ASSEMBLY_BUNDLE_SUFFIX = ".assembly.json"
ASSEMBLY_MAPS_SUFFIX = ".maps.npz"


def _is_calibration(name: str) -> bool:
    return name == CALIBRATION_BASENAME or name.endswith(CALIBRATION_SUFFIX)


def _known_json_artifact(name: str) -> bool:
    # Heartbeats are per-process files: obs/heartbeat_p<N>.json
    # (training/loop.py) or any heartbeat*.json an operator configured.
    return (name in KNOWN_UNVERIFIED_BASENAMES
            or (name.startswith("heartbeat") and name.endswith(".json")))

_SKIP_DIR_NAMES = {"__pycache__"}


def _is_step_dir(path: str) -> bool:
    """A checkpoint step: an integer-named directory directly under a
    ``best/``, ``last/``, or ``mid/`` (intra-epoch cadence saves,
    training/checkpoint.py) root."""
    name = os.path.basename(path)
    parent = os.path.basename(os.path.dirname(path))
    return name.isdigit() and parent in ("best", "last", "mid")


def _check_tree(path: str, report: Dict) -> None:
    kind = artifacts.CHECKPOINT_KIND  # same label the restore path uses
    try:
        manifest = artifacts.verify_tree(path, require_sidecar=False)
    except artifacts.ArtifactError as exc:
        _mark_corrupt(path, str(exc), kind, report)
        return
    if manifest is None:
        if not os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")):
            _mark_corrupt(path, "torn save: _CHECKPOINT_METADATA missing",
                          kind, report)
        else:
            report["unverified_paths"].append(path)
        return
    if not os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")):
        _mark_corrupt(path, "torn save: _CHECKPOINT_METADATA missing",
                      kind, report)
        return
    report["verified"] += 1


def _check_file(path: str, report: Dict, require_sidecar: bool = False) -> None:
    try:
        manifest = artifacts.verify_file(path,
                                         require_sidecar=require_sidecar)
    except artifacts.ArtifactError as exc:
        kind = "artifact"
        sc = None
        try:
            sc = artifacts.read_sidecar(path)
        except artifacts.ArtifactError:
            pass
        if isinstance(sc, dict):
            kind = sc.get("kind", kind)
        _mark_corrupt(path, str(exc), kind, report)
        return
    if manifest is None:
        if _known_json_artifact(os.path.basename(path)):
            try:
                with open(path, encoding="utf-8") as fh:
                    json.load(fh)
            except (OSError, ValueError) as exc:
                _mark_corrupt(path, f"unverified JSON artifact does not "
                                    f"parse: {exc}", "legacy-json", report)
                return
        report["unverified_paths"].append(path)
        return
    report["verified"] += 1


def _check_heartbeat(path: str, report: Dict) -> None:
    """Liveness classification through the ONE shared staleness check
    (obs/heartbeat.read_heartbeat — the same helper the fleet AND
    training supervisors probe with), so fsck and supervision cannot
    disagree about "how old is too old". Staleness is informational (the
    writer may simply have finished), never a corruption — integrity is
    checked separately above. The writing host rides along (training
    heartbeats are per-process files), so a pod operator sees WHICH host
    went quiet straight from the contract line."""
    from deepinteract_tpu_torch.obs.heartbeat import read_heartbeat

    status = read_heartbeat(path, HEARTBEAT_MAX_AGE_S)
    host = None
    if status.payload is not None:
        host = status.payload.get("process_index",
                                  status.payload.get("host"))
    report.setdefault("heartbeats", {})[path] = {
        "status": status.status,
        "age_s": (round(status.age_s, 1)
                  if status.age_s is not None else None),
        "host": host,
    }
    if status.status == "stale":
        report["stale_heartbeats"] = report.get("stale_heartbeats", 0) + 1
        report.setdefault("stale_heartbeat_hosts", []).append(
            host if host is not None else os.path.basename(path))


def _check_trainer_cursor(path: str, report: Dict) -> None:
    """Validate the mid-epoch resume cursor (--save_every_steps,
    training/loop.py) riding trainer_state.json: a structurally damaged
    cursor would corrupt the next --resume's ledger, so it is flagged
    (and quarantined) as corruption, not styled over. A healthy cursor
    surfaces in the fsck/v1 contract so an operator sees where the run
    would resume without opening the file."""
    if any(e["path"] == path for e in report["corrupt_paths"]):
        return  # integrity layer already flagged (and maybe moved) it
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return  # already flagged by the parse checks above
    cur = payload.get("cursor") if isinstance(payload, dict) else None
    if cur is None:
        return
    problems = []
    if not isinstance(cur, dict):
        problems.append("cursor is not an object")
    else:
        for key in ("epoch", "batch_index", "opt_step", "skips_used",
                    "skipped_steps"):
            v = cur.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                problems.append(f"cursor.{key} is not a non-negative int")
        ledger = cur.get("loss_ledger")
        if (not isinstance(ledger, list)
                or not all(isinstance(x, (int, float))
                           and not isinstance(x, bool) for x in ledger)):
            problems.append("cursor.loss_ledger is not a number list")
        elif (isinstance(cur.get("batch_index"), int)
                and len(ledger) > cur["batch_index"]):
            problems.append("cursor.loss_ledger longer than batch_index")
    if problems:
        _mark_corrupt(path, "resume cursor malformed: "
                      + "; ".join(problems), "trainer-state", report)
        return
    report["resume_cursor"] = {
        "epoch": cur["epoch"], "batch_index": cur["batch_index"],
        "opt_step": cur["opt_step"], "skips_used": cur["skips_used"],
    }


def _check_fleet_state(path: str, report: Dict) -> None:
    """Validate the elastic-fleet records riding fleet_state.json
    (serving/fleet.py ``set_extra_state``): the autoscaler's persisted
    target (serving/autoscaler.py) and the router's version weights /
    shadow config (serving/router.py). A structurally damaged record
    would be resumed verbatim by the next supervisor life — a malformed
    target respawns the wrong fleet, malformed weights break the canary
    split — so it is flagged (and quarantined) as corruption, not styled
    over. Healthy records surface in the fsck/v1 contract: per-version
    worker counts, the autoscale target, and any stale agreement ledgers
    (``agreement_<version>.jsonl`` for a version that is neither weighted
    nor the shadow candidate — promotion evidence nothing can consume)."""
    if any(e["path"] == path for e in report["corrupt_paths"]):
        return  # integrity layer already flagged (and maybe moved) it
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return  # already flagged by the parse checks above
    if not isinstance(payload, dict):
        return
    problems = []

    def nonneg_int(v) -> bool:
        return isinstance(v, int) and not isinstance(v, bool) and v >= 0

    autoscale = payload.get("autoscale")
    if autoscale is not None:
        if not isinstance(autoscale, dict):
            problems.append("autoscale is not an object")
        else:
            for key in ("target_workers", "scale_ups", "scale_downs"):
                if key in autoscale and not nonneg_int(autoscale[key]):
                    problems.append(
                        f"autoscale.{key} is not a non-negative int")
            if not nonneg_int(autoscale.get("target_workers")):
                problems.append("autoscale.target_workers missing")
    versions = payload.get("versions")
    weights, shadow = {}, None
    if versions is not None:
        if not isinstance(versions, dict):
            problems.append("versions is not an object")
        else:
            weights = versions.get("weights", {})
            if (not isinstance(weights, dict)
                    or not all(isinstance(k, str)
                               and isinstance(v, (int, float))
                               and not isinstance(v, bool) and v >= 0
                               for k, v in weights.items())):
                problems.append("versions.weights is not a "
                                "version->non-negative-number map")
                weights = {}
            shadow = versions.get("shadow")
            if shadow is not None and (
                    not isinstance(shadow, dict)
                    or not isinstance(shadow.get("candidate"), str)):
                problems.append("versions.shadow has no candidate")
                shadow = None
            if ("promotions" in versions
                    and not nonneg_int(versions["promotions"])):
                problems.append("versions.promotions is not a "
                                "non-negative int")
    if problems:
        _mark_corrupt(path, "fleet state records malformed: "
                      + "; ".join(problems), "fleet-state", report)
        return
    by_version: Dict[str, int] = {}
    workers = payload.get("workers")
    if isinstance(workers, dict):
        for snap in workers.values():
            if not isinstance(snap, dict) or snap.get("state") != "healthy":
                continue
            health = snap.get("health")
            sig = (health.get("weights_signature")
                   if isinstance(health, dict) else None)
            if isinstance(sig, str):
                by_version[sig] = by_version.get(sig, 0) + 1
    entry: Dict = {"workers_by_version": by_version}
    if isinstance(autoscale, dict):
        entry["autoscale_target"] = autoscale.get("target_workers")
    if weights:
        entry["version_weights"] = weights
    report["fleet_versions"] = entry
    # Agreement ledgers beside the state file that no live version can
    # consume: promotion evidence for a version that is neither weighted
    # nor shadowed is stale — it must never promote by accident.
    live = set(weights) | ({shadow["candidate"]} if shadow else set())
    state_dir = os.path.dirname(path)
    try:
        names = sorted(os.listdir(state_dir))
    except OSError:
        names = []
    for name in names:
        if (name.startswith("agreement_") and name.endswith(".jsonl")
                and name[len("agreement_"):-len(".jsonl")] not in live):
            report.setdefault("stale_version_ledgers", []).append(
                os.path.join(state_dir, name))


def _check_index_manifest(path: str, report: Dict) -> None:
    """Census the proteome-index partition manifest (cli/index.py
    ``build``). Byte integrity is covered by the sidecar check above;
    here the structure is validated (a manifest whose partition table
    does not parse would wedge every indexed /screen at 400) and the
    partition count + weights_signature are collected so ``main`` can
    cross-reference against the served fleet versions: an index frozen
    at a signature NO healthy worker serves is promotion debt — queries
    against it either 409 at the server or silently rank with stale
    weights under --allow_stale."""
    if any(e["path"] == path for e in report["corrupt_paths"]):
        return  # integrity layer already flagged (and maybe moved) it
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return  # already flagged by the parse checks above
    if not isinstance(payload, dict):
        return
    sig = payload.get("weights_signature")
    partitions = payload.get("partitions")
    problems = []
    if not isinstance(sig, str) or not sig:
        problems.append("weights_signature missing")
    if not isinstance(partitions, list) or not all(
            isinstance(p, dict) and isinstance(p.get("partition_id"), str)
            and isinstance(p.get("file"), str)
            for p in partitions):
        problems.append("partitions is not a partition-record list")
        partitions = []
    else:
        index_dir = os.path.dirname(path)
        missing = [p["partition_id"] for p in partitions
                   if not os.path.exists(os.path.join(index_dir,
                                                      p["file"]))]
        if missing:
            problems.append("manifest references missing shards: "
                            + ", ".join(missing[:5]))
    if problems:
        _mark_corrupt(path, "index manifest malformed: "
                      + "; ".join(problems), "index-manifest", report)
        return
    report["index_partitions"] = (report.get("index_partitions", 0)
                                  + len(partitions))
    report.setdefault("index_manifests", []).append({
        "path": path, "weights_signature": sig,
        "partitions": len(partitions),
        "chains": payload.get("num_chains"),
    })


def _check_calibration(path: str, report: Dict) -> None:
    """Census a fitted calibration map (calibration/calibrator.py
    ``save_calibration``). Byte integrity is covered by the sidecar
    check above; here the structure is validated (a malformed map would
    400 every ``--calibration`` run at load) and the weights_signature
    is collected so ``main`` can cross-reference against the served
    fleet versions — a calibration fitted for weights NO healthy worker
    serves is promotion debt, exactly like a stale index partition:
    applying it silently mis-scales the successor model's
    probabilities."""
    if any(e["path"] == path for e in report["corrupt_paths"]):
        return  # integrity layer already flagged (and maybe moved) it
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return  # already flagged by the parse checks above
    if not isinstance(payload, dict):
        return
    problems = []
    sig = payload.get("weights_signature")
    if not isinstance(sig, str) or not sig:
        problems.append("weights_signature missing")
    if payload.get("schema") != "calibration/v1":
        problems.append(f"schema is {payload.get('schema')!r}, "
                        "want 'calibration/v1'")
    method = payload.get("method")
    if method not in ("temperature", "isotonic", "identity"):
        problems.append(f"method {method!r} unknown")
    elif method == "temperature":
        t = payload.get("temperature")
        if not isinstance(t, (int, float)) or isinstance(t, bool) or t <= 0:
            problems.append("temperature is not a positive number")
    elif method == "isotonic":
        xs, ys = payload.get("iso_x"), payload.get("iso_y")
        if (not isinstance(xs, list) or not isinstance(ys, list)
                or len(xs) != len(ys) or not xs):
            problems.append("isotonic knots missing or mismatched")
    if problems:
        _mark_corrupt(path, "calibration malformed: " + "; ".join(problems),
                      "calibration", report)
        return
    report.setdefault("calibrations", []).append({
        "path": path, "weights_signature": sig, "method": method,
    })


def _check_assembly_bundle(path: str, report: Dict) -> None:
    """Validate an assembly bundle manifest (cli/assemble.py): the
    interface graph must be structurally sound and every output file it
    references (ranked jsonl, maps npz) must still exist beside it — a
    bundle pointing at deleted outputs is a torn hand-off, flagged as
    corruption so ``--quarantine`` moves it aside rather than letting a
    downstream consumer trust a dangling manifest."""
    if any(e["path"] == path for e in report["corrupt_paths"]):
        return  # integrity layer already flagged (and maybe moved) it
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return  # already flagged by the parse checks above
    if not isinstance(payload, dict):
        return
    problems = []
    sig = payload.get("weights_signature")
    if not isinstance(sig, str) or not sig:
        problems.append("weights_signature missing")
    if payload.get("schema") != "assembly-bundle/v1":
        problems.append(f"schema is {payload.get('schema')!r}, "
                        "want 'assembly-bundle/v1'")
    interface = payload.get("interface")
    if (not isinstance(interface, dict)
            or not isinstance(interface.get("nodes"), list)
            or not isinstance(interface.get("edges"), list)):
        problems.append("interface is not a nodes/edges graph")
    files = payload.get("files")
    if not isinstance(files, dict) or not isinstance(
            files.get("ranked"), str):
        problems.append("files.ranked missing")
    else:
        bundle_dir = os.path.dirname(path)
        missing = [v for v in (files.get("ranked"), files.get("maps"))
                   if isinstance(v, str)
                   and not os.path.exists(os.path.join(bundle_dir, v))]
        if missing:
            problems.append("bundle references missing outputs: "
                            + ", ".join(missing))
    if problems:
        _mark_corrupt(path, "assembly bundle malformed: "
                      + "; ".join(problems), "assembly-bundle", report)
        return
    report["assembly_bundles"] = report.get("assembly_bundles", 0) + 1


def _mark_corrupt(path: str, reason: str, kind: str, report: Dict) -> None:
    report["corrupt_paths"].append({"path": path, "kind": kind,
                                    "reason": reason})
    if report["do_quarantine"]:
        dest = artifacts.quarantine(path, kind, reason)
        if dest is not None:
            report["quarantined"] += 1
            print(f"CORRUPT {path}: {reason} -> quarantined {dest}")
            return
    print(f"CORRUPT {path}: {reason}")


def scan(root: str, do_quarantine: bool, do_sweep: bool) -> Dict:
    report: Dict = {
        "verified": 0, "quarantined": 0, "tmp_swept": 0,
        "corrupt_paths": [], "unverified_paths": [], "orphan_sidecars": [],
        "tmp_paths": [], "do_quarantine": do_quarantine,
    }
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIR_NAMES
                       and ".corrupt-" not in d]
        # Directory artifacts first: a step dir is checked as one unit
        # and not descended into (its files are covered by the tree
        # sidecar; flagging each payload shard separately would be
        # noise).
        step_dirs = [d for d in list(dirnames)
                     if _is_step_dir(os.path.join(dirpath, d))]
        for d in step_dirs:
            dirnames.remove(d)
            _check_tree(os.path.join(dirpath, d), report)
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            if ".corrupt-" in name:
                continue
            if name.endswith(artifacts.TMP_SUFFIX):
                report["tmp_paths"].append(path)
                continue
            if name.endswith(artifacts.SIDECAR_SUFFIX):
                target = path[: -len(artifacts.SIDECAR_SUFFIX)]
                if not os.path.exists(target):
                    report["orphan_sidecars"].append(path)
                continue
            has_sidecar = os.path.exists(artifacts.sidecar_path(path))
            # Embedding spills and index shards REQUIRE a sidecar (their
            # readers quarantine strays); everything else degrades to
            # unverified.
            spill = name.startswith("emb_") and name.endswith(".npz")
            shard = (name.startswith(INDEX_SHARD_PREFIX)
                     and name.endswith(".npz"))
            idx_manifest = name == INDEX_MANIFEST_BASENAME
            calibration = _is_calibration(name)
            bundle = name.endswith(ASSEMBLY_BUNDLE_SUFFIX)
            asm_maps = name.endswith(ASSEMBLY_MAPS_SUFFIX)
            sidecar_required = (spill or shard or idx_manifest
                                or calibration or bundle or asm_maps)
            if (has_sidecar or sidecar_required
                    or _known_json_artifact(name)):
                _check_file(path, report,
                            require_sidecar=sidecar_required)
            if idx_manifest:
                _check_index_manifest(path, report)
            if calibration:
                _check_calibration(path, report)
            if bundle:
                _check_assembly_bundle(path, report)
            if name == "trainer_state.json":
                _check_trainer_cursor(path, report)
            if name == "fleet_state.json":
                _check_fleet_state(path, report)
            if name.startswith("heartbeat") and name.endswith(".json"):
                _check_heartbeat(path, report)
    if do_sweep or do_quarantine:
        for path in report["tmp_paths"]:
            try:
                os.unlink(path)
                report["tmp_swept"] += 1
            except OSError:
                pass
        for path in report["orphan_sidecars"]:
            try:
                os.unlink(path)
            except OSError:
                pass
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("root", help="run directory to check (checkpoint "
                                     "dir, spill dir, or a parent of both)")
    parser.add_argument("--quarantine", action="store_true",
                        help="move corrupt artifacts aside as "
                             "<name>.corrupt-<ts> (and sweep tmp/orphan "
                             "strays) so the next run recovers cleanly")
    parser.add_argument("--sweep_tmp", action="store_true",
                        help="remove orphaned *.tmp files from killed "
                             "writers (report-only otherwise)")
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root)
    if not os.path.isdir(root):
        print(f"error: {root} is not a directory", file=sys.stderr)
        return 2

    report = scan(root, args.quarantine, args.sweep_tmp)

    for path, hb in sorted(report.get("heartbeats", {}).items()):
        if hb["status"] == "stale":
            host = (f" host {hb['host']}" if hb.get("host") is not None
                    else "")
            print(f"stale heartbeat ({hb['age_s']}s old){host}: {path}")
    for path in report["unverified_paths"]:
        print(f"unverified (no integrity sidecar): {path}")
    for path in report["orphan_sidecars"]:
        print(f"orphan sidecar (target gone): {path}")
    for path in report.get("stale_version_ledgers", []):
        print("stale version ledger (version neither weighted nor "
              f"shadowed): {path}")
    # An index partition is STALE when its frozen weights_signature
    # matches no version a healthy worker serves (fleet_state.json
    # census above) — the embeddings can still be read, but indexed
    # /screen against them either 409s at version check or ranks with
    # weights the fleet has moved past. Only judged when a fleet census
    # exists in the scanned tree: a bare index directory has no serving
    # context to be stale AGAINST.
    served = set(((report.get("fleet_versions") or {})
                  .get("workers_by_version") or {}))
    stale_index = []
    if served:
        for m in report.get("index_manifests", []):
            if m["weights_signature"] not in served:
                stale_index.append(m["path"])
                print(f"stale index partitions ({m['partitions']} @ "
                      f"weights {m['weights_signature']}, served "
                      f"versions {sorted(served)}): {m['path']}")
    # Same promotion-debt rule for calibrations: a fitted map whose
    # frozen weights_signature matches no served version would silently
    # mis-scale whatever model replaced those weights. Judged only
    # against a fleet census found in the scanned tree.
    stale_cal = []
    if served:
        for c in report.get("calibrations", []):
            if c["weights_signature"] not in served:
                stale_cal.append(c["path"])
                print(f"stale calibration ({c['method']} @ weights "
                      f"{c['weights_signature']}, served versions "
                      f"{sorted(served)}): {c['path']}")
    for path in report["tmp_paths"]:
        swept = " (swept)" if (args.sweep_tmp or args.quarantine) else ""
        print(f"orphan tmp: {path}{swept}")

    corrupt = len(report["corrupt_paths"])
    ok = corrupt == 0
    recovered = corrupt > 0 and report["quarantined"] == corrupt
    contract = {
        "schema": "fsck/v1",
        "metric": "fsck_corrupt_artifacts",
        "value": float(corrupt),
        "unit": "artifacts",
        "ok": ok,
        "root": root,
        "scanned": report["verified"] + len(report["unverified_paths"])
                   + corrupt,
        "verified": report["verified"],
        "unverified": len(report["unverified_paths"]),
        "corrupt": corrupt,
        "quarantined": report["quarantined"],
        "recovered": recovered,
        "orphan_sidecars": len(report["orphan_sidecars"]),
        "stale_heartbeats": report.get("stale_heartbeats", 0),
        "stale_heartbeat_hosts": report.get("stale_heartbeat_hosts", []),
        "resume_cursor": report.get("resume_cursor"),
        "fleet_versions": report.get("fleet_versions"),
        "stale_version_ledgers": report.get("stale_version_ledgers", []),
        "index_partitions": report.get("index_partitions", 0),
        "stale_index_partitions": stale_index,
        "calibrations": len(report.get("calibrations", [])),
        "stale_calibrations": stale_cal,
        "assembly_bundles": report.get("assembly_bundles", 0),
        "tmp_files": len(report["tmp_paths"]),
        "tmp_swept": report["tmp_swept"],
        "corrupt_paths": [e["path"] for e in report["corrupt_paths"][:20]],
    }
    print(json.dumps(contract))
    if ok or recovered:
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
