"""Campaign orchestration (counterpart of stfem_tpu/utils/campaign.py):
parameter files under content-hashed names (the reference's
tests/json/generate.py and generate_parameters.sh), one runner script per
file (its job_generator.py, retargeted from SLURM/MPI to one host
running the port's drivers on its card), and the tables pulled out of the
run logs (its submit_job_postprocess.sh).  JSON and text only."""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path


def content_hashed_name(params: dict, prefix: str = "cfg") -> str:
    blob = json.dumps(params, sort_keys=True).encode()
    return f"{prefix}_{hashlib.sha1(blob).hexdigest()[:12]}.json"


def generate_parameter_file(base: dict, overrides: dict, out_dir: str,
                            prefix: str = "cfg") -> str:
    """Merge overrides into the base config and write it under a
    content-hashed name (reference tests/json/generate.py:7-11)."""
    merged = dict(base)
    merged.update(overrides)
    path = Path(out_dir) / content_hashed_name(merged, prefix)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(merged, indent=4))
    return str(path)


def generate_convergence_campaign(out_dir: str, problem: str = "heat",
                                  types=("DG", "CGP"),
                                  distort_coeffs=(0.0, 0.5),
                                  steps_at_once=(1, 2, 4)) -> list[str]:
    """The reference's convergence campaign matrix
    (generate_parameters.sh:5-36)."""
    base = {
        "doOutput": "false", "spaceTimeMg": "true",
        "problemType": problem, "feDegree": "1", "nDegCycles": "3",
        "nRefCycles": "4", "refinement": "2", "usePMg": "true",
        "coarseningType": "space_and_time",
    }
    return [generate_parameter_file(
        base, {"timeType": t, "distortCoeff": str(d),
               "nTimestepsAtOnce": str(n)}, out_dir,
        prefix=f"{problem}_{t}")
        for t in types for d in distort_coeffs for n in steps_at_once]


def emit_job_script(config_path: str, out_dir: str, dim: int = 3,
                    driver: str = "stfem_tpu_torch.drivers.tp01") -> str:
    """A runner script for one config on one host (the reference's
    job_generator.py emits SLURM/srun scripts)."""
    name = Path(config_path).stem
    script = Path(out_dir) / f"run_{name}.sh"
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text(
        "#!/bin/bash\nset -e\n"
        f"python -m {driver} --file {config_path} --dim {dim} "
        f"| tee {out_dir}/{name}.log\n")
    os.chmod(script, 0o755)
    return str(script)


def extract_tables(log_text: str) -> dict[str, list[str]]:
    """The convergence and iteration-count tables of a driver log (the
    reference's postprocess awk, submit_job_postprocess.sh:33-35: from a
    'Convergence table' or 'Iteration count table' header to the next
    blank line).  Returns {header: [table lines incl. header]}."""
    out: dict[str, list[str]] = {}
    lines = log_text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.startswith(("Convergence table",
                                "Iteration count table")):
            continue
        block = [line]
        while i < len(lines) and lines[i].strip():
            block.append(lines[i])
            i += 1
        out.setdefault(line.strip(), []).extend(block)
    return out


def postprocess_campaign(out_dir: str, dest_dir: str | None = None) -> dict:
    """The tables of every run log in out_dir, written per log into
    dest_dir/<log name>/{convergence,iterations}.txt (the reference's
    submit_job_postprocess.sh layout; dest_dir defaults to
    out_dir/output).  Returns {log name: extracted tables}."""
    out_dir = Path(out_dir)
    dest = Path(dest_dir) if dest_dir else out_dir / "output"
    results = {}
    for log in sorted(out_dir.glob("*.log")):
        tables = extract_tables(log.read_text())
        results[log.stem] = tables
        tdir = dest / log.stem
        tdir.mkdir(parents=True, exist_ok=True)
        for header, block in tables.items():
            fname = ("convergence.txt" if header.startswith("Convergence")
                     else "iterations.txt")
            (tdir / fname).write_text("\n".join(block) + "\n")
    return results
