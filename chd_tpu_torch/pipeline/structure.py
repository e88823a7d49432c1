"""Dataset layout helper: directory-of-videos → directory-of-directories
(port of chd_tpu/pipeline/structure.py, host code; replaces
scripts/create_optim_data_structure.py:24-46)."""
from __future__ import annotations

import os
import shutil
from typing import List


def create_optim_data_structure(data_path: str, out_path: str, move: bool = False) -> List[str]:
    """Each <name>.mp4 in data_path becomes out_path/<name>/<name>.mp4."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(data_path)
    os.makedirs(out_path, exist_ok=True)
    made = []
    for f in sorted(os.listdir(data_path)):
        if not f.endswith(".mp4"):
            continue
        name = f[: -len(".mp4")]
        vdir = os.path.join(out_path, name)
        os.makedirs(vdir, exist_ok=True)
        src = os.path.join(data_path, f)
        dst = os.path.join(vdir, f)
        (shutil.move if move else shutil.copyfile)(src, dst)
        made.append(vdir)
    return made
