"""The port's library surface against chd_tpu's, read by ``ast`` (no import
of chd_tpu): every public top-level name of every ``chd_tpu/**/*.py`` (a
def, a class or an assignment; in a package's ``__init__.py`` also what it
imports from the package) is bound at the top level of the port's module of
the same path, or is one of the meant differences below, each naming the
port's counterpart, which must resolve. An entry that the port has since
bound, or that chd_tpu no longer has, fails too, so the list stays true.
"""
import ast
import glob
import importlib
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chd_tpu's module → the port's, where the port's has another name
MODULES = {"ops/pallas_mlp.py": "ops/fused_mlp.py"}
# (chd_tpu module, name) → (the port's counterpart, how it differs)
MEANT = {
    ("models/contact_mlp.py", "apply"):
        ("chd_tpu_torch.models.contact_mlp.ContactMLP.forward",
         "an nn.Module; training mode updates its BN buffers in place"),
    ("models/contact_mlp.py", "predict_logits"):
        ("chd_tpu_torch.models.contact_mlp.ContactMLP.forward",
         "eval mode returns (B, 4 * P); callers reshape"),
    ("models/torch_convert.py", "load_torch_checkpoint"):
        ("chd_tpu_torch.models.torch_convert.load_pth",
         "a ContactMLP from a reference .pth"),
    ("ops/voting.py", "merge_votes"):
        ("chd_tpu_torch.ops.voting.merge_votes_batch", "a batch of videos"),
    ("ops/windows.py", "featurize_video"):
        ("chd_tpu_torch.ops.windows.featurize_batch", "a batch of videos"),
    ("ops/windows.py", "extract_windows"):
        ("chd_tpu_torch.ops.windows.featurize_batch", "strided windows of a batch"),
    ("ops/pallas_mlp.py", "TILE_B"):
        ("chd_tpu_torch.ops.fused_mlp.fused_mlp",
         "the CUDA kernel takes 64-row blocks and pads no rows"),
    ("kinematics/residuals.py", "residual_fn_for"):
        ("chd_tpu_torch.kinematics.residuals.Layout.residual",
         "a callable of a Layout holding the tree's constants on a device"),
    ("kinematics/residuals.py", "SMOOTH_VEL_XYZ"):
        ("chd_tpu_torch.kinematics.residuals.Layout",
         "Layout.smooth_xyz, a tensor on the layout's device"),
    ("kinematics/ik.py", "SOLVE_CHUNK"):
        ("chd_tpu_torch.kinematics.ik.solve_ck_ik",
         "one batched solve over every frame: the chunks bound the TPU's VMEM"),
    ("utils/log.py", "stage_timer"):
        ("chd_tpu_torch.utils.profiling.span",
         "the pipeline's stages are spans, logged by pipeline.run"),
}


def _bound(path: str, surface: bool) -> set:
    """Top-level names of a module: what it defines (``surface``: public
    names, and in an ``__init__.py`` its imports from the package), or
    everything bound at its top level."""
    tree = ast.parse(open(path).read())
    init = os.path.basename(path) == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                names |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if surface and not (init and isinstance(node, ast.ImportFrom) and node.level):
                continue
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")} if surface else names


def _pairs():
    for path in sorted(glob.glob(os.path.join(REPO, "chd_tpu", "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, os.path.join(REPO, "chd_tpu"))
        yield rel, MODULES.get(rel, rel)


@pytest.mark.parametrize("rel, port_rel", list(_pairs()))
def test_every_public_name_has_a_counterpart(rel, port_rel):
    port = os.path.join(REPO, "chd_tpu_torch", port_rel)
    assert os.path.isfile(port), f"no port module {port_rel}"
    want = _bound(os.path.join(REPO, "chd_tpu", rel), surface=True)
    have = _bound(port, surface=False)
    missing = sorted(n for n in want - have if (rel, n) not in MEANT)
    assert missing == [], f"chd_tpu/{rel}: {missing} not in chd_tpu_torch/{port_rel}"


@pytest.mark.parametrize("key", sorted(MEANT))
def test_meant_differences_are_true(key):
    rel, name = key
    assert name in _bound(os.path.join(REPO, "chd_tpu", rel), surface=True)
    assert name not in _bound(os.path.join(REPO, "chd_tpu_torch", MODULES.get(rel, rel)),
                              surface=False)
    ref = MEANT[key][0].split(".")
    for split in range(len(ref), 0, -1):
        try:
            obj = importlib.import_module(".".join(ref[:split]))
        except ModuleNotFoundError:
            continue
        for attr in ref[split:]:
            obj = getattr(obj, attr)
        return
    raise AssertionError(f"{MEANT[key][0]} does not resolve")


def test_constants_added_for_the_surface_equal_chd_tpu():
    """The data among the names the surface guard asked for (the defs tables
    are in tests/test_torch_core.py); the package re-exports are the
    modules' own objects."""
    from chd_tpu.models import contact_mlp as jax_mlp
    from chd_tpu.pipeline import run as jax_run
    from chd_tpu_torch import parallel
    from chd_tpu_torch.models import contact_mlp
    from chd_tpu_torch.parallel import distributed, longseq, mesh
    from chd_tpu_torch.pipeline import run

    assert run.DEFAULT_SKEL == jax_run.DEFAULT_SKEL
    assert contact_mlp.DROPOUT_LAYER == jax_mlp.DROPOUT_LAYER
    assert isinstance(contact_mlp.ContactMLP(9, 4).model[9], torch.nn.Dropout)
    assert parallel.contact_model_shardings is mesh.contact_model_shardings
    assert parallel.distributed_initialize is distributed.initialize
    assert parallel.lm_solve_frame_sharded is longseq.lm_solve_frame_sharded
