"""Synthetic end-to-end harness for the experiment suites, through the
port's CLIs (counterpart of mst_tpu/utils/scripts_e2e.py).

The reference's `scripts/**` grids are its CLI test surface. This module
builds a miniature on-disk world (raw SDD/inD trees, every filtered pkl a
script references, tiny pretrained checkpoints per model family) and runs
each suite, unchanged, with a reduced grid, asserting the reference's
'Average performance (by N)' contract: 91 experiment suites and the 2
preprocessing pipelines.

The scripts call `python train.py`, `python test.py` and
`python -m mst_tpu.<module>`; the sandbox redirects them to the port:
- its train.py / test.py are shims that run `mst_tpu_torch.train` /
  `mst_tpu_torch.test`;
- `bin/python`, first on the PATH the suites see, rewrites
  `-m mst_tpu.<x>` to `-m mst_tpu_torch.<x>` and execs this interpreter;
- the device is fixed when the sandbox is built (build_sandbox(dst,
  device=...)): the shims pass --device to every CLI that takes one;
- `guard/sitecustomize.py`, first on the PYTHONPATH the suites see, makes
  jax and mst_tpu unimportable, so a green suite ran the port.

Grid reduction: every script sources `$MST_GRID_OVERRIDES` (if set) after
its variable block, so the harness pins seeds/lr/n_train/epochs to one
cheap value while keeping each script's distinguishing flags (train_net,
position, network, sequential val_files, --augment) exactly as written.

    python -m mst_tpu_torch.utils.scripts_e2e build|sweep|list \\
        [--sandbox DIR] [--device cuda|cpu] [--only a,b] [--out JSON]
"""

import os
import pathlib
import re
import shlex
import subprocess
import sys

import numpy as np

REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[2])
DEFAULT_SANDBOX = os.path.join(REPO_ROOT, "build", "scripts_e2e")

# raw synthetic image sizes chosen so every script family lands on the SAME
# padded device shape per dataset:
# sdd: 128x192 * 0.25 -> 32x48 -> pad/32 -> 32x64
# inD: 96x160 * 0.33 -> 32x53 -> pad/32 -> 32x64
_RAW_HW = {"sdd": (128, 192), "inD-dataset-v1.0": (96, 160)}

_TINY_OVERRIDES = dict(
    encoder_channels=[8, 8, 16, 16, 16],
    decoder_channels=[16, 16, 16, 8, 8],
    n_semantic_classes=3,  # identity segmentation passes the RGB channels
    n_goal=5,
)

# the CLIs the scripts run with `-m` that take --device (the data
# builders and the converter run on the host)
_DEVICE_CLIS = ("mst_tpu_torch.train", "mst_tpu_torch.test",
                "mst_tpu_torch.grid")
# what a suite process may not import
_BLOCKED = ("jax", "jaxlib", "mst_tpu")

_GRID_OVERRIDES = """\
# reduced grid for the synthetic e2e sweep (sourced by every script when
# MST_GRID_OVERRIDES is set; flag-combination vars like list_train_net /
# list_position / network / extra_flags stay as the script defines them)
list_seed=(1)
list_train_seed=(1)
list_lr=(0.003)
list_n_train_batch=(1)
batch_size=4
n_epoch=2
n_early_stop=100
n_round=1
steps=20
test_splits=4
val_split=0.34
save_every_n=1000
# preprocessing-pipeline split sizes: the reference's absolute val/test
# counts (80/500, 20/114, ...) exceed the miniature fixtures' trajectory
# counts, so the sweep runs the same stages with ratio splits
prep_dc0_val=0.2
prep_dc0_test=0.3
prep_low_val=0.2
prep_low_test=0.3
prep_high_val=0.2
prep_high_test=0.3
prep_s1ped_val=0.2
prep_s1ped_test=0.3
prep_s2ped_val=0.2
prep_s2ped_test=0.3
prep_s3ped_val=0.2
prep_s3ped_test=0.3
prep_truck_val=0.2
prep_truck_test=0.3
prep_stped_val=0.2
prep_stped_test=0.3
"""


def parse_script_vars(path):
    """Top-level `name=value` / `name=(a b c)` assignments of a suite
    script -> dict (arrays become lists; last assignment wins)."""
    out = {}
    for line in pathlib.Path(path).read_text().splitlines():
        m = re.match(r"^(\w+)=\((.*)\)\s*$", line)
        if m:
            out[m.group(1)] = shlex.split(m.group(2))
            continue
        m = re.match(r"^(\w+)=(\S.*?)\s*$", line)
        if m and not line.lstrip().startswith("#"):
            out[m.group(1)] = m.group(2).strip('"')
    return out


def experiment_scripts(repo_root=REPO_ROOT):
    """All runnable suite scripts (excludes data-bundle fetch/convert and
    the preprocessing pipelines, which get their own fixture path)."""
    skip = {"get_pretrained_model_and_data.sh", "convert_reference_ckpts.sh",
            "preprocessing.sh", "run_all_synthetic.sh", "run_parity.sh"}
    root = pathlib.Path(repo_root) / "scripts"
    return sorted(str(p.relative_to(repo_root)) for p in root.rglob("*.sh")
                  if p.name not in skip)


def _dataset_name(config_filename):
    return "sdd" if str(config_filename).startswith("sdd") \
        else "inD-dataset-v1.0"


def collect_requirements(scripts, repo_root=REPO_ROOT):
    """Scan suite scripts -> (datasets, ckpts).

    datasets: {(ds_name, dataset_path): spec} where spec has total_len,
      mode ('predefined'|'sequential') and the sequential file names.
    ckpts: {relpath: (config_filename, network, n_fusion)}.
    """
    import yaml

    cfg_cache = {}

    def horizon(cfg_name):
        if cfg_name not in cfg_cache:
            with open(os.path.join(repo_root, "mst_tpu_torch", "configs",
                                   cfg_name)) as f:
                c = yaml.safe_load(f)
            cfg_cache[cfg_name] = int(c["obs_len"]) + int(c["pred_len"])
        return cfg_cache[cfg_name]

    datasets, ckpts = {}, {}
    for rel in scripts:
        v = parse_script_vars(os.path.join(repo_root, rel))
        cfg = v.get("config_filename")
        if not cfg or "dataset_path" not in v:
            continue
        ds = _dataset_name(cfg)
        key = (ds, v["dataset_path"].rstrip("/"))
        spec = datasets.setdefault(key, {
            "total_len": horizon(cfg), "modes": set(), "files": set()})
        spec["total_len"] = max(spec["total_len"], horizon(cfg))
        mode = v.get("load_data", "predefined")
        spec["modes"].add(mode)
        if mode == "sequential":
            for fkey in ("train_files", "val_files"):
                if fkey in v:
                    spec["files"].add(v[fkey])
        net = v.get("network", "original")
        if "n_fusion" in v:  # inD ynetmod style: n_fusion=2 + --n_fusion $n_fusion
            nf = int(v["n_fusion"])
        elif "--n_fusion" in v.get("extra_flags", ""):
            nf = int(v["extra_flags"].split("--n_fusion")[1].split()[0])
        else:
            nf = None
        for ck in ("pretrained_ckpt", "ckpts"):
            if ck in v and "$" not in v[ck]:
                ckpts[v[ck]] = (cfg, net, nf)
    return datasets, ckpts


def _write_scene_tree(root, ds_name, images):
    """Scene images on disk in each dataset's layout."""
    import cv2

    base = pathlib.Path(root) / "data" / ds_name
    for scene, im in images.items():
        u8 = (np.asarray(im) * 255).astype(np.uint8)
        if ds_name == "sdd":
            # use_raw_data layout: raw/annotations/<name>/video<i>/
            name, idx = scene.split("_")
            d = base / "raw" / "annotations" / name / f"video{idx}"
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / "reference.jpg"), u8)
        else:
            d = base / "images" / scene
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / "reference.png"), u8)


def _cli_shim(module, device):
    """A root train.py / test.py that runs the port's CLI `module`."""
    return f'''"""Runs {module} on {device} (written by
mst_tpu_torch.utils.scripts_e2e.build_sandbox)."""
import runpy
import sys

sys.argv = [{module!r}] + sys.argv[1:] + ["--device", {device!r}]
runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
'''


def _python_shim(device):
    """bin/python: `-m mst_tpu.<x>` -> `-m mst_tpu_torch.<x>` (with
    --device where the CLI takes it), then exec this interpreter."""
    return f'''#!{sys.executable}
"""The experiment scripts' `python` (written by
mst_tpu_torch.utils.scripts_e2e.build_sandbox): runs the port's module
in place of the reference package's, on {device}."""
import os
import sys

EXE = {sys.executable!r}
DEVICE_CLIS = {_DEVICE_CLIS!r}
args = sys.argv[1:]
if len(args) >= 2 and args[0] == "-m":
    head, _, rest = args[1].partition(".")
    if head == "mst_tpu":
        args[1] = "mst_tpu_torch" + ("." + rest if rest else "")
        if args[1] in DEVICE_CLIS:
            args += ["--device", {device!r}]
os.execv(EXE, [EXE] + args)
'''


_GUARD = f'''"""Makes {", ".join(_BLOCKED)} unimportable in the suites' processes
(written by mst_tpu_torch.utils.scripts_e2e)."""
import sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError(f"{{name}} may not be imported by a suite "
                              "of the port")
        return None


sys.meta_path.insert(0, _Refuse())
'''


def write_shims(dst, device="cuda"):
    """The sandbox's redirections (see the module docstring), for
    `device` -> {name: path}."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    dst = pathlib.Path(dst)
    paths = {"train.py": dst / "train.py", "test.py": dst / "test.py",
             "python": dst / "bin" / "python",
             "sitecustomize": dst / "guard" / "sitecustomize.py"}
    for p in paths.values():
        p.parent.mkdir(parents=True, exist_ok=True)
        if p.is_symlink():
            p.unlink()
    paths["train.py"].write_text(_cli_shim("mst_tpu_torch.train", device))
    paths["test.py"].write_text(_cli_shim("mst_tpu_torch.test", device))
    paths["python"].write_text(_python_shim(device))
    paths["python"].chmod(0o755)
    paths["sitecustomize"].write_text(_GUARD)
    return paths


def synthetic_frame(tracks, label="Pedestrian"):
    """The port's synthetic Tracks -> mst_tpu's synthetic DataFrame
    (mst_tpu/data/synthetic.py: x, y, frame, trackId, sceneId, metaId,
    label; trackId is the walk's index within its scene)."""
    import pandas as pd

    first = {}
    for m, s in zip(tracks.metaId, tracks.sceneId):
        first.setdefault(s, m)
    track_id = tracks.metaId - np.array([first[s] for s in tracks.sceneId],
                                        np.int64)
    return pd.DataFrame({
        "x": tracks.x, "y": tracks.y, "frame": tracks.frame,
        "trackId": track_id, "sceneId": list(tracks.sceneId),
        "metaId": tracks.metaId, "label": [label] * len(tracks)})


def build_sandbox(dst, repo_root=REPO_ROOT, scripts=None, device="cuda"):
    """Create a self-contained sandbox the suites can run from, its CLIs
    on `device`."""
    import yaml

    from mst_tpu_torch.data.synthetic import make_synthetic_dataset

    dst = pathlib.Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    scripts = scripts or experiment_scripts(repo_root)
    write_shims(dst, device)

    # tiny configs under the SAME filenames; the local config/ dir shadows
    # the packaged ones (mst_tpu_torch/config.py resolution order)
    cfg_dir = dst / "config"
    cfg_dir.mkdir(exist_ok=True)
    cfg_src = pathlib.Path(repo_root) / "mst_tpu_torch" / "configs"
    for cfg_path in sorted(cfg_src.glob("*.yaml")):
        cfg = yaml.safe_load(cfg_path.read_text())
        cfg.update(_TINY_OVERRIDES)
        (cfg_dir / cfg_path.name).write_text(yaml.safe_dump(cfg))

    datasets, ckpts = collect_requirements(scripts, repo_root)

    # ---- data fixtures ----------------------------------------------------
    images_by_ds = {}
    seed = 0
    for (ds, dpath), spec in sorted(datasets.items()):
        seed += 1
        tracks, images = make_synthetic_dataset(
            seed=seed, n_scenes=2, n_traj=8, total_len=spec["total_len"],
            img_hw=_RAW_HW[ds])
        df = synthetic_frame(tracks)
        images_by_ds.setdefault(ds, {}).update(images)
        ddir = dst / "data" / ds / dpath
        ddir.mkdir(parents=True, exist_ok=True)
        ids = df.metaId.unique()
        if "predefined" in spec["modes"]:
            df[df.metaId.isin(ids[:10])].to_pickle(ddir / "train.pkl")
            df[df.metaId.isin(ids[10:13])].to_pickle(ddir / "val.pkl")
            df[df.metaId.isin(ids[13:])].to_pickle(ddir / "test.pkl")
        for fname in spec["files"]:
            df.to_pickle(ddir / fname)
    for ds, images in images_by_ds.items():
        _write_scene_tree(dst, ds, images)

    # ---- tiny pretrained checkpoints per model family ---------------------
    _build_ckpts(dst, ckpts)

    (dst / "overrides.sh").write_text(_GRID_OVERRIDES)
    return dst


def _build_ckpts(dst, ckpts):
    """Each checkpoint the scripts load: the port's init_ynet (seed 7) in
    mst_tpu's npz layout (io.params_to_numpy) with its json sidecar."""
    import json

    import torch

    from mst_tpu_torch import config as config_lib
    from mst_tpu_torch import io
    from mst_tpu_torch.models import ynet as ynet_lib

    for rel, (cfg_name, network, n_fusion) in sorted(ckpts.items()):
        path = pathlib.Path(dst) / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        overrides = dict(_TINY_OVERRIDES)
        overrides.update(network=network, segmentation_model_fp=None)
        if n_fusion is not None:
            overrides["n_fusion"] = n_fusion
        params_dict = config_lib.get_params(
            config_filename=str(pathlib.Path(dst) / "config" / cfg_name),
            overrides=overrides)
        mcfg = config_lib.ynet_config(params_dict)
        params, _ = ynet_lib.init_ynet(torch.Generator().manual_seed(7),
                                       mcfg)
        np.savez(path, **io.params_to_numpy(params))
        with open(str(path) + ".json", "w") as f:
            json.dump({"synthetic_fixture": True, "network": network,
                       "config": cfg_name}, f, indent=1, default=str)


def suite_env(sandbox, repo_root=REPO_ROOT, env_extra=None):
    """The environment a suite runs in: the sandbox's python first on
    PATH, its import guard and the repo on PYTHONPATH, the reduced
    grid."""
    sandbox = pathlib.Path(sandbox)
    env = dict(os.environ)
    env["PATH"] = str(sandbox / "bin") + os.pathsep + env.get("PATH", "")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(sandbox / "guard"), repo_root]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["MST_GRID_OVERRIDES"] = str(sandbox / "overrides.sh")
    env.update(env_extra or {})
    return env


def run_script(script_rel, sandbox, repo_root=REPO_ROOT, timeout=1800,
               env_extra=None):
    """Execute one suite script from the sandbox with the reduced grid.

    Returns (returncode, combined_output).
    """
    proc = subprocess.run(
        ["bash", os.path.join(repo_root, script_rel)],
        cwd=str(sandbox), env=suite_env(sandbox, repo_root, env_extra),
        timeout=timeout, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc.returncode, proc.stdout


def expected_runs(script_rel, repo_root=REPO_ROOT):
    """How many CLI invocations the reduced grid performs = how many
    'Average performance' blocks a green run must print (train.py prints
    one after its own test; test.py prints one per checkpoint)."""
    v = parse_script_vars(os.path.join(repo_root, script_rel))
    n = 1
    for key in ("list_train_net", "list_position"):
        if key in v:
            n *= max(1, len(v[key]))
    if "ckpts" in v:  # test.py: one block per --ckpts entry
        n *= max(1, len(v["ckpts"]) if isinstance(v["ckpts"], list) else 1)
    return n


# ---------------------------------------------------------------------------
# raw-data fixtures + preprocessing pipelines
# ---------------------------------------------------------------------------

def _reflect(p, lo, hi):
    """Triangle-wave reflection of positions into [lo, hi]: keeps a
    constant-speed track inside the canvas without the velocity-zeroing
    that border clipping causes (avg_vel drives the style buckets)."""
    span = hi - lo
    q = np.mod(np.asarray(p, dtype=np.float64) - lo, 2 * span)
    return lo + np.where(q > span, 2 * span - q, q)


def build_raw_fixtures(dst, seed=11):
    """Miniature RAW datasets for the preprocessing suites: an SDD
    annotations tree (scripts/sdd/preprocessing.sh — all 8 scenes the
    multiscene_easy/dc_013 stages reference) and the 33 inD recording CSV
    pairs + scene background images (scripts/inD/preprocessing.sh)."""
    import cv2
    import pandas as pd

    rng = np.random.default_rng(seed)
    dst = pathlib.Path(dst)

    # --- SDD: annotations/<scene>/video<N>/annotations.txt -----------------
    # short-term step=12 x window=20 needs >= 229 raw frames; LONG-term
    # step=30 x window=35 needs >= 1021, so 1080 serves both. avg_vel is
    # measured in RAW px/frame and the bucket ranges are (0.5, 3.5) /
    # (4, 8); tracks bounce off the borders (reflection) so every window
    # keeps its nominal speed regardless of travel distance.
    n_frames, hw = 1080, (720, 1280)
    frames_idx = np.arange(n_frames)
    sdd_scenes = (("deathCircle", "video0"), ("deathCircle", "video1"),
                  ("deathCircle", "video3"), ("gates", "video1"),
                  ("gates", "video3"), ("gates", "video4"),
                  ("little", "video0"), ("little", "video3"))
    for scene, video in sdd_scenes:
        d = dst / "data" / "sdd" / "raw" / "annotations" / scene / video
        d.mkdir(parents=True, exist_ok=True)
        rows = []
        tid = 0
        for label in ("Pedestrian", "Biker"):
            for j in range(3):
                # spread speeds across the velocity buckets so the
                # avg_vel datasets (dc_013 low/high) are non-empty
                speed = (1.0, 2.5, 4.8)[j]
                vx = speed * rng.choice([-1.0, 1.0])
                vy = rng.uniform(-0.5, 0.5)
                cx = _reflect(rng.uniform(6, hw[1] - 6) + vx * frames_idx,
                              6, hw[1] - 6)
                cy = _reflect(rng.uniform(6, hw[0] - 6) + vy * frames_idx,
                              6, hw[0] - 6)
                for f in range(n_frames):
                    rows.append(f"{tid} {cx[f] - 2:.1f} {cy[f] - 2:.1f} "
                                f"{cx[f] + 2:.1f} {cy[f] + 2:.1f} {f} 0 0 0 "
                                f'"{label}"')
                tid += 1
        (d / "annotations.txt").write_text(
            "trackId xmin ymin xmax ymax frame lost occluded generated "
            "label\n" + "\n".join(rows) + "\n")
        img = (rng.uniform(0, 1, size=(*hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(d / "reference.jpg"), img)

    # --- inD: <rec>_tracks.csv + <rec>_tracksMeta.csv -----------------------
    # long-term step=25 x window=35 needs >= 851 raw frames; 900 gives 1
    # window. Speeds (m/frame) chosen so every label clears the
    # avg_vel >= 0.2 px/frame filter after the meter->px conversion
    # (scene1 ~6.6 px/m, others ~10.2 px/m).
    ind_dir = dst / "data" / "inD-dataset-v1.0" / "data"
    ind_dir.mkdir(parents=True, exist_ok=True)
    n_frames = 900
    frames_idx = np.arange(n_frames)
    for rec_num in range(33):
        rec = f"{rec_num:02d}"
        tracks, metas = [], []
        for tid, (label, speed) in enumerate((("pedestrian", 0.05),
                                              ("car", 0.12),
                                              ("truck_bus", 0.09))):
            ang = rng.uniform(0, 2 * np.pi)
            xs = _reflect(rng.uniform(1, 19) + speed * np.cos(ang)
                          * frames_idx, 0.5, 20.0)
            ys = _reflect(-rng.uniform(1, 19) + speed * np.sin(ang)
                          * frames_idx, -20.0, -0.5)  # raw yCenter <= 0
            for f in range(n_frames):
                tracks.append((rec_num, tid, f, xs[f], ys[f]))
            metas.append((tid, label, n_frames))
        pd.DataFrame(tracks, columns=[
            "recordingId", "trackId", "frame", "xCenter", "yCenter"
        ]).to_csv(ind_dir / f"{rec}_tracks.csv", index=False)
        pd.DataFrame(metas, columns=["trackId", "class", "numFrames"]
                     ).to_csv(ind_dir / f"{rec}_tracksMeta.csv", index=False)
    # scene background images the pipeline's image-prep stage copies
    for bg in ("00", "07", "18", "30"):
        img = (rng.uniform(0, 1, size=(96, 160, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(ind_dir / f"{bg}_background.png"), img)
    return dst


def run_preprocessing(sandbox, repo_root=REPO_ROOT, timeout=1800,
                      env_extra=None, device="cuda"):
    """Run both preprocessing pipelines against the raw fixtures.

    Uses an isolated `prep/` sandbox (with the same redirections): the
    SDD builder walks EVERY scene under raw/annotations, so the experiment
    fixtures' image-only scene dirs must not be visible to it. Returns
    {script: (rc, output)}."""
    prep = pathlib.Path(sandbox) / "prep"
    if prep.exists():  # the mv/rm stages are not rerunnable in place
        # Only wipe directories this harness built (marked by overrides.sh);
        # refuse to delete a user directory that happens to be named prep/.
        if not (prep / "overrides.sh").exists():
            raise RuntimeError(
                f"{prep} exists but lacks the harness marker overrides.sh; "
                "refusing to delete a directory this harness did not build. "
                "Remove it manually or point --sandbox elsewhere.")
        import shutil
        shutil.rmtree(prep)
    # marker FIRST: an interrupted build must remain self-healing (the
    # guard above keys on the marker, so a half-built prep/ without it
    # would otherwise need a manual rmtree)
    prep.mkdir(parents=True, exist_ok=True)
    (prep / "overrides.sh").write_text(_GRID_OVERRIDES)
    write_shims(prep, device)
    build_raw_fixtures(prep)
    out = {}
    for rel in ("scripts/sdd/preprocessing.sh", "scripts/inD/preprocessing.sh"):
        out[rel] = run_script(rel, prep, repo_root, timeout=timeout,
                              env_extra=env_extra)
    return out


# ---------------------------------------------------------------------------
# sweep CLI: python -m mst_tpu_torch.utils.scripts_e2e sweep [...]
# ---------------------------------------------------------------------------

def _main(argv=None):
    import argparse
    import json
    import time

    parser = argparse.ArgumentParser(
        description="synthetic end-to-end sweep of the experiment suites")
    parser.add_argument("command", choices=["build", "sweep", "list"])
    parser.add_argument("--sandbox", default=DEFAULT_SANDBOX)
    parser.add_argument("--out", default=None,
                        help="results JSON (default: "
                             "<sandbox>/scripts_e2e_results.json)")
    parser.add_argument("--only", default=None,
                        help="substring filter on script paths; "
                             "comma-separated alternatives select the "
                             "union")
    parser.add_argument("--timeout", type=int, default=1800)
    parser.add_argument("--skip_preprocessing", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="skip suites already ok in --out")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the device of every CLI the suites run "
                             "(cuda must exist)")
    parser.add_argument("--resume_log", default=None,
                        help="seed --resume state from a sweep stdout log"
                             " (recovers an interrupted run's ok lines)")
    args = parser.parse_args(argv)
    if args.command != "list":
        from mst_tpu_torch import resolve_device

        resolve_device(args.device)
    if args.out is None:
        args.out = os.path.join(args.sandbox, "scripts_e2e_results.json")

    scripts = experiment_scripts()
    if args.only:
        pats = [p for p in args.only.split(",") if p]
        scripts = [s for s in scripts if any(p in s for p in pats)]
    if args.command == "list":
        print("\n".join(scripts))
        return

    sb = pathlib.Path(args.sandbox)
    if not (sb / "overrides.sh").exists():
        print(f"[e2e] building sandbox at {sb}", flush=True)
        build_sandbox(sb, device=args.device)
    else:
        write_shims(sb, args.device)
    if args.command == "build":
        return

    done = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f).get("results", {})
        done.update({k: v for k, v in prev.items() if v.get("ok")})
    if args.resume_log and os.path.exists(args.resume_log):
        # "[e2e] ok  <script> (N/M runs, Xs, i/total)" lines of an
        # interrupted sweep (its final JSON never got written)
        line_re = re.compile(
            r"^\[e2e\] ok\s+(\S+)(?: \((\d+)/(\d+) runs, ([\d.]+)s)?")
        for line in open(args.resume_log):
            m = line_re.match(line)
            if not m:
                continue
            rel = m.group(1)
            entry = {"rc": 0, "ok": True, "resumed_from_log": True}
            if m.group(2):
                entry.update(n_avg=int(m.group(2)), expected=int(m.group(3)),
                             seconds=float(m.group(4)))
            done[rel] = entry
    if done:
        print(f"[e2e] resuming: {len(done)} suites already ok", flush=True)

    results, n_ok = {}, 0
    t_all = time.time()
    for rel, entry in done.items():
        # explicit provenance tag: the summary's fresh/resumed split must
        # count carried-over entries by MARK, not by value equality
        results[rel] = {**entry, "resumed": True}
        n_ok += 1
    if args.skip_preprocessing:
        pass
    elif all(p in done for p in ("scripts/sdd/preprocessing.sh",
                                 "scripts/inD/preprocessing.sh")):
        pass
    else:
        for rel, (rc, out) in run_preprocessing(
                sb, timeout=args.timeout, device=args.device).items():
            ok = rc == 0
            results[rel] = {"rc": rc, "ok": ok,
                            "tail": out[-2000:] if not ok else ""}
            n_ok += ok
            print(f"[e2e] {'ok ' if ok else 'FAIL'} {rel}", flush=True)
    for i, rel in enumerate(scripts):
        if rel in done:
            continue
        t = time.time()
        try:
            rc, out = run_script(rel, sb, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            rc, out = -9, "TIMEOUT"
        n_avg = len(re.findall(r"Average performance \(by ", out))
        want = expected_runs(rel)
        ok = rc == 0 and n_avg >= want
        n_ok += ok
        results[rel] = {"rc": rc, "n_avg": n_avg, "expected": want,
                        "ok": ok, "seconds": round(time.time() - t, 1),
                        "tail": out[-2000:] if not ok else ""}
        print(f"[e2e] {'ok ' if ok else 'FAIL'} {rel} "
              f"({n_avg}/{want} runs, {results[rel]['seconds']}s, "
              f"{i + 1}/{len(scripts)})", flush=True)
    import datetime

    n_resumed = sum(1 for v in results.values() if v.get("resumed"))
    summary = {"total": len(results), "ok": n_ok,
               "seconds": round(time.time() - t_all, 1),
               # when it was produced, on which device, and how many
               # entries were fresh executions vs carried over
               "device": args.device,
               "generated_at": datetime.datetime.now(
                   datetime.timezone.utc).isoformat(timespec="seconds"),
               "fresh": len(results) - n_resumed, "resumed": n_resumed,
               "results": results}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[e2e] {n_ok}/{len(results)} suites green in "
          f"{summary['seconds']}s -> {args.out}", flush=True)
    sys.exit(0 if n_ok == len(results) else 1)


if __name__ == "__main__":
    _main()
