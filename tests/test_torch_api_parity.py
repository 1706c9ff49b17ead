"""Every name of the JAX package has a counterpart in the port.

Reads both packages' sources with `ast` and imports neither. For every
module of `ms_slam_tpu/`, each top-level function, class, assigned name and
class method must exist in the port's module of the same path
(`ms_slam_tpu_torch/...`), or stand in MAPPED below: private helpers of the
reference whose work the port does under another name, each with the port
file and function that does it.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "ms_slam_tpu")
PORT = os.path.join(ROOT, "ms_slam_tpu_torch")

# reference name -> the port's file:function that does its work
MAPPED = {
    "pipeline/system.py": {
        "System._dev_scalar": "pipeline/system.py:System._dispatch_track "
                              "(host scalars passed as they are)",
        "_mp_obs_count_jit": "models/map_state.py:mp_obs_count",
        "_observer_mask_jit": "models/map_state.py:observer_mask",
        "_delete_one_kf": "pipeline/system.py:System._evict_oldest_kf",
        "matching_TH_LOW": "ops/matching.py:TH_LOW",
        "System._tic": "utils/trace.py:span (the System's spans)",
    },
    "pipeline/loop_closing.py": {
        "_verify_pair_impl": "pipeline/loop_closing.py:_verify_pair",
    },
    "pipeline/mapping_ops.py": {
        "_triangulate_impl": "pipeline/mapping_ops.py:_triangulate_batch",
    },
    "utils/config.py": {
        "_load_yaml": "utils/config.py:load_opencv_yaml",
    },
    "ops/orb.py": {
        "_patch_kernel_body": "csrc/patch_gather.cu (the hand kernel)",
        "extract_patches_canvas_pallas": "ops/orb.py:extract_patches_canvas",
        "_binned_pattern_matrices": "ops/orb.py:_binned_pair_index_np",
        "_moment_matrix": "ops/orb.py:_moment_matrix_np",
        "_canvas_masks": "ops/orb.py:_canvas_masks_np",
        "_ARC_LEN": "ops/orb.py:fast_score_batched",
    },
    "ops/pose_graph.py": {
        "_edge_residual_4dof": "ops/pose_graph.py:optimize_pose_graph_4dof",
    },
}


def _names(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{b.name}" for b in node.body
                        if isinstance(b, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def _modules():
    mods = []
    for root, _, files in os.walk(REF):
        for f in sorted(files):
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(root, f), REF))
    return sorted(mods)


@pytest.mark.parametrize("mod", _modules())
def test_module_has_every_name(mod):
    port = os.path.join(PORT, mod)
    assert os.path.exists(port), f"no port of ms_slam_tpu/{mod}"
    missing = _names(os.path.join(REF, mod)) - _names(port) \
        - set(MAPPED.get(mod, {}))
    assert not missing, sorted(missing)


def test_mapped_helpers_exist_on_both_sides():
    """Each mapped name is still in the reference, and the port function
    it maps to exists."""
    for mod, table in MAPPED.items():
        ref = _names(os.path.join(REF, mod))
        for name, target in table.items():
            assert name in ref, (mod, name)
            path, _, func = target.split(" ")[0].partition(":")
            full = os.path.join(PORT, path)
            assert os.path.exists(full), target
            if func:
                assert func in _names(full), target
