"""Script and artifact archiver: keep-lists, glob patterns, dry runs,
timestamped collision-safe destination names.

The port's copy of `review_recommender_tpu/tools/archiver.py` (standard
library only): moves non-essential files out of a working directory into
an `_archive/` subdirectory, the housekeeping tool the reference used to
retire pipeline scripts without deleting them.

    python -m review_recommender_tpu_torch.tools.archiver DIR
        [--patterns '*.py' ...] [--keep NAME_OR_GLOB ...] [--dry-run]
"""
from __future__ import annotations

import argparse
import fnmatch
import logging
import shutil
import time
from pathlib import Path
from typing import List, Sequence

logger = logging.getLogger(__name__)


def should_keep(name: str, keep: Sequence[str]) -> bool:
    """Keep-list check: exact names or glob patterns."""
    return any(name == k or fnmatch.fnmatch(name, k) for k in keep)


def unique_dest(dest_dir: Path, name: str) -> Path:
    """Collision-safe destination: append a timestamp when taken."""
    dest = dest_dir / name
    if not dest.exists():
        return dest
    stamp = time.strftime("%Y%m%d-%H%M%S")
    p = Path(name)
    return dest_dir / f"{p.stem}.{stamp}{p.suffix}"


def archive_files(
    src_dir: str | Path,
    patterns: Sequence[str] = ("*.py",),
    keep: Sequence[str] = (),
    archive_name: str = "_archive",
    dry_run: bool = False,
) -> List[dict]:
    """Move matching files (minus keep-list) into src_dir/_archive.
    Returns the action list: [{src, dest, moved}]."""
    src = Path(src_dir)
    dest_dir = src / archive_name
    actions: List[dict] = []
    for path in sorted(src.iterdir()):
        if not path.is_file():
            continue
        if not any(fnmatch.fnmatch(path.name, p) for p in patterns):
            continue
        if should_keep(path.name, keep):
            continue
        dest = unique_dest(dest_dir, path.name)
        actions.append({"src": str(path), "dest": str(dest), "moved": not dry_run})
        if not dry_run:
            dest_dir.mkdir(parents=True, exist_ok=True)
            shutil.move(str(path), str(dest))
            logger.info("archived %s -> %s", path.name, dest)
    return actions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Archive non-essential files")
    ap.add_argument("src_dir")
    ap.add_argument("--patterns", nargs="+", default=["*.py"])
    ap.add_argument("--keep", nargs="+", default=[])
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    actions = archive_files(args.src_dir, args.patterns, args.keep,
                            dry_run=args.dry_run)
    for a in actions:
        print(("DRY  " if args.dry_run else "MOVE ") + a["src"] + " -> " + a["dest"])
    print(f"{len(actions)} file(s) {'would be ' if args.dry_run else ''}archived")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
