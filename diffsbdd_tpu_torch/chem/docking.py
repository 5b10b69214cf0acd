"""Docking scores through external binaries: smina, QuickVina2, obabel and
MGLTools' ``prepare_receptor4.py``, run with ``subprocess``.

- ``smina_score``: ``smina.static --score_only`` of SDF ligands against a
  receptor, one score per molecule (NaN where none is parsed).
- ``calculate_qvina2_score``: redocking with QuickVina2 (obabel SDF -> PDBQT,
  a 20 A box at the ligand's centre, exhaustiveness 16).
- ``main``: the batch-scoring CLI over a directory of generated SDFs.

    python -m diffsbdd_tpu_torch.chem.docking --pdbqt_dir <dir> --sdf_dir <dir> --out_dir <dir> [--write_csv] [--write_dict] [--dataset moad|crossdocked]

Every binary is optional; a missing one raises FileNotFoundError naming it.
"""
from __future__ import annotations

import argparse
import csv
import pickle
import re
import shutil
import subprocess
import tempfile
import warnings
from pathlib import Path
from typing import List, Union

import numpy as np

from diffsbdd_tpu_torch.chem.sdfio import read_sdf, write_sdf_file


def _require(binary: str):
    if shutil.which(binary) is None:
        raise FileNotFoundError(
            f"external binary '{binary}' not found on PATH — install it to "
            f"run docking evaluation")


def calculate_smina_score(pdb_file, sdf_file) -> List[float]:
    """The 'Affinity: <x> (kcal/mol)' values of ``smina --score_only``."""
    _require("smina.static")
    out = subprocess.run(
        ["smina.static", "-l", str(sdf_file), "-r", str(pdb_file),
         "--score_only"],
        capture_output=True, text=True).stdout
    matches = re.findall(
        r"Affinity:[ ]+([+-]?[0-9]*[.]?[0-9]+)[ ]+\(kcal/mol\)", out)
    return [float(x) for x in matches]


def smina_score(mols, receptor_file: Union[str, List[str]]) -> List[float]:
    """Scores of ``mols`` against one receptor, or one receptor a molecule
    (a list of the same length); always ``len(mols)`` entries, NaN where a
    score is missing, so that no score pairs with the wrong molecule."""
    if isinstance(receptor_file, list):
        if len(receptor_file) != len(mols):
            raise ValueError(
                f"{len(mols)} molecules but {len(receptor_file)} receptors "
                f"— per-molecule scoring needs a 1:1 pairing")
        scores = []
        for mol, rec in zip(mols, receptor_file):
            with tempfile.NamedTemporaryFile(suffix=".sdf") as tmp:
                write_sdf_file(tmp.name, [mol])
                res = calculate_smina_score(rec, tmp.name)
                scores.append(res[0] if res else float("nan"))
        return scores
    with tempfile.NamedTemporaryFile(suffix=".sdf") as tmp:
        write_sdf_file(tmp.name, mols)
        scores = calculate_smina_score(receptor_file, tmp.name)
    if len(scores) != len(mols):
        # which molecule a parsed score belongs to is unknown
        warnings.warn(f"smina returned {len(scores)} affinities for "
                      f"{len(mols)} molecules; discarding ambiguous scores")
        return [float("nan")] * len(mols)
    return scores


def pdb_to_pdbqt(pdb_file, pdbqt_file, dataset: str = "crossdocked"):
    """Receptor preparation with ``prepare_receptor4.py``; Binding MOAD
    receptors also get ``-A checkhydrogens -e`` (add missing hydrogens, drop
    non-standard residues).  An existing output is kept."""
    pdbqt_file = Path(pdbqt_file)
    if pdbqt_file.exists():
        return pdbqt_file
    _require("prepare_receptor4.py")
    cmd = ["prepare_receptor4.py", "-r", str(pdb_file),
           "-o", str(pdbqt_file)]
    if dataset in ("bindingmoad", "moad"):
        cmd += ["-A", "checkhydrogens", "-e"]
    elif dataset != "crossdocked":
        raise NotImplementedError(
            f"unknown dataset '{dataset}' (crossdocked | bindingmoad)")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0 or not pdbqt_file.exists():
        raise RuntimeError(
            f"prepare_receptor4.py failed for {pdb_file} "
            f"(rc={res.returncode}): {res.stderr[-500:]}")
    return pdbqt_file


def pdbs_to_pdbqts(pdb_dir, pdbqt_dir, dataset: str = "crossdocked"):
    """``pdb_to_pdbqt`` of every ``*.pdb`` in a directory."""
    pdbqt_dir = Path(pdbqt_dir)
    pdbqt_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for f in sorted(Path(pdb_dir).glob("*.pdb")):
        outfile = pdbqt_dir / (f.stem + ".pdbqt")
        out.append(pdb_to_pdbqt(f, outfile, dataset))
        print(f"Wrote converted file to {outfile}")
    return out


def sdf_to_pdbqt(sdf_file, pdbqt_outfile, mol_id: int):
    """Molecule ``mol_id`` (0-based) of an SDF file as PDBQT, by obabel."""
    _require("obabel")
    subprocess.run(
        ["obabel", str(sdf_file), "-O", str(pdbqt_outfile),
         "-f", str(mol_id + 1), "-l", str(mol_id + 1)],
        capture_output=True)
    return pdbqt_outfile


_QVINA_TABLE = "-----+------------+----------+----------"


def calculate_qvina2_score(receptor_file, sdf_file, out_dir, size: int = 20,
                           exhaustiveness: int = 16, return_mols: bool = False):
    """QuickVina2 redocking of every ligand of an SDF file: the best mode's
    affinity of each, NaN for a block that does not parse or a run without a
    result table; with ``return_mols`` also the docked pose of each (None
    where there is none).  A ligand whose ``<name>_out.sdf`` exists already
    is read back, not docked again."""
    _require("qvina2.1")
    receptor_file = Path(receptor_file)
    sdf_file = Path(sdf_file)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if receptor_file.suffix == ".pdb":
        receptor_pdbqt = pdb_to_pdbqt(
            receptor_file, Path(out_dir, receptor_file.stem + ".pdbqt"))
    else:
        receptor_pdbqt = receptor_file

    scores, out_mols = [], []
    # molecule i must be obabel's block i (-f/-l), so unparsed blocks stay
    for i, mol in enumerate(read_sdf(sdf_file, keep_invalid=True)):
        name = f"{sdf_file.stem}_{i}"
        ligand_pdbqt = Path(out_dir, name + ".pdbqt")
        out_sdf = Path(out_dir, name + "_out.sdf")

        if mol is None:
            scores.append(float("nan"))
            if return_mols:
                out_mols.append(None)
            continue
        if out_sdf.exists():
            with open(out_sdf) as f:
                scores.append(min(
                    float(line.split()[2]) for line in f
                    if line.startswith(" VINA RESULT:")))
        else:
            sdf_to_pdbqt(sdf_file, ligand_pdbqt, i)
            cx, cy, cz = np.asarray(mol.coords).mean(0)
            out = subprocess.run(
                ["qvina2.1",
                 "--receptor", str(receptor_pdbqt),
                 "--ligand", str(ligand_pdbqt),
                 "--center_x", f"{cx:.4f}", "--center_y", f"{cy:.4f}",
                 "--center_z", f"{cz:.4f}",
                 "--size_x", str(size), "--size_y", str(size),
                 "--size_z", str(size),
                 "--exhaustiveness", str(exhaustiveness)],
                capture_output=True, text=True).stdout
            ligand_pdbqt.unlink(missing_ok=True)

            if _QVINA_TABLE not in out:
                scores.append(float("nan"))
                if return_mols:
                    out_mols.append(None)
                continue
            lines = out.splitlines()
            best = lines[lines.index(_QVINA_TABLE) + 1].split()
            assert best[0] == "1"
            scores.append(float(best[1]))

            out_pdbqt = Path(out_dir, name + "_out.pdbqt")
            if out_pdbqt.exists():
                subprocess.run(["obabel", str(out_pdbqt), "-O", str(out_sdf)],
                               capture_output=True)
                out_pdbqt.unlink()

        if return_mols:
            docked = read_sdf(out_sdf) if out_sdf.exists() else []
            out_mols.append(docked[0] if docked else None)

    return (scores, out_mols) if return_mols else scores


def _write_csv(path, results):
    """``results`` (equal-length columns) as a CSV whose first, unnamed
    column is the row index."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["", *results])
        for i, row in enumerate(zip(*results.values())):
            writer.writerow([i, *row])


def main(argv=None):
    """QuickVina2-score every SDF of a directory (or the files given)
    against its receptor; ``--write_csv`` writes ``qvina2_scores.csv`` and
    ``--write_dict`` the pickle ``qvina2_scores.pkl``.

    For ``--dataset moad`` ligand files are ``<receptor>_<pocket>_<suffix>.sdf``
    with the receptor at ``<pdbqt_dir>/<receptor>.pdbqt``; for ``--dataset
    crossdocked`` the receptor's name is the ligand file's stem without its
    last 4 characters."""
    parser = argparse.ArgumentParser("QuickVina evaluation")
    parser.add_argument("--pdbqt_dir", type=Path, required=True,
                        help="Receptor files in pdbqt format")
    parser.add_argument("--sdf_dir", type=Path, default=None,
                        help="Ligand files in sdf format")
    parser.add_argument("--sdf_files", type=Path, nargs="+", default=None)
    parser.add_argument("--out_dir", type=Path, required=True)
    parser.add_argument("--write_csv", action="store_true")
    parser.add_argument("--write_dict", action="store_true")
    parser.add_argument("--dataset", type=str, default="moad",
                        choices=["moad", "crossdocked"])
    args = parser.parse_args(argv)

    assert (args.sdf_dir is not None) ^ (args.sdf_files is not None), \
        "give exactly one of --sdf_dir / --sdf_files"
    args.out_dir.mkdir(parents=True, exist_ok=True)

    results = {"receptor": [], "ligand": [], "scores": []}
    results_dict = {}
    sdf_files = sorted(args.sdf_dir.glob("[!.]*.sdf")) \
        if args.sdf_dir is not None else args.sdf_files
    for sdf_file in sdf_files:
        ligand_name = sdf_file.stem
        if args.dataset == "moad":
            receptor_name = ligand_name.split("_")[0]
        else:  # crossdocked: strip the 4-character suffix ('_gen')
            receptor_name = ligand_name[:-4]
        receptor_file = Path(args.pdbqt_dir, receptor_name + ".pdbqt")

        scores, mols = calculate_qvina2_score(
            receptor_file, sdf_file, args.out_dir, return_mols=True)
        print(f"{ligand_name}: {scores}")
        results["receptor"].append(str(receptor_file))
        results["ligand"].append(str(sdf_file))
        results["scores"].append(scores)
        if args.write_dict:
            results_dict[ligand_name] = {
                "receptor": str(receptor_file), "ligand": str(sdf_file),
                "scores": scores, "mols": mols,
            }

    if args.write_csv:
        _write_csv(Path(args.out_dir, "qvina2_scores.csv"), results)
    if args.write_dict:
        with open(Path(args.out_dir, "qvina2_scores.pkl"), "wb") as f:
            pickle.dump(results_dict, f)
    return results


if __name__ == "__main__":
    main()
