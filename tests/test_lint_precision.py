"""Repo lint: every device matmul must pass an explicit precision.

On a GPU a float32 matmul without a precision may run in TF32 (about
three decimal digits), and the CPU test mesh cannot see it — a bare ``a @ b`` on a
traced path ships a silent numerics regression that only an on-chip
test can catch (it happened: the FIR state matmuls in ``ops/sos.py``
carried ~3e-3 into the scipy-exact edge samples until
``test_batch_detect_envelope_on_device`` ran on real hardware).  This
lint freezes the bug class: in every module that imports jax, the
``@`` operator is banned outright and ``matmul/dot/einsum/
dot_general/conv_general_dilated`` calls must carry a ``precision``
keyword.  Host-side numpy modules (no jax import) are exempt.
"""

import ast
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "audian_tpu"

_MATMUL_NAMES = {"matmul", "dot", "einsum", "dot_general",
                 "conv_general_dilated", "tensordot"}

# Modules that import jax but whose matmuls all run on HOST numpy
# arrays (verified by reading every call site when added here):
_HOST_SIDE = {
    # filter design: all products act on np.ndarray at design time
    # (impulse-response/state-matrix construction, lstsq refinement);
    # jax is imported only for pytree registration of the designs
    "audian_tpu/ops/design.py",
}


def _imports_jax(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "jax" or a.name.startswith("jax.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module and (node.module == "jax"
                                or node.module.startswith("jax.")):
                return True
    return False


def _call_name(func):
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def test_every_matmul_carries_explicit_precision():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        if not _imports_jax(tree):
            continue  # host-side numpy module: device precision n/a
        rel = path.relative_to(PKG.parent)
        if str(rel) in _HOST_SIDE:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                offenders.append(
                    f"{rel}:{node.lineno}: bare `@` matmul (use "
                    f"jnp.matmul(..., precision=...))")
            elif isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name in _MATMUL_NAMES:
                    if not any(kw.arg == "precision"
                               for kw in node.keywords):
                        offenders.append(
                            f"{rel}:{node.lineno}: {name}() without "
                            f"precision=")
    assert not offenders, "\n".join(offenders)
