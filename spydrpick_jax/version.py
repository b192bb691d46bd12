"""Version info (reference: include/SpydrPick_version.h:28-30 is v1.3.0)."""

__version__ = "0.2.0"

TITLE = "spydrpick-jax: JAX MI-ARACNE genome-wide co-evolution analysis"


def _git_revision() -> str | None:
    """branch-hash of the installed source tree, if it is a git checkout
    (this engine's analogue of the reference's compiled-in
    SPYDRPICK_GIT_BRANCH/SPYDRPICK_GIT_COMMIT_HASH,
    src/SpydrPick_options.cpp:58-79)."""
    import os
    import subprocess

    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD",
             "--abbrev-ref", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode != 0:
            return None
        commit, branch = out.stdout.split()
        return f"{branch}-{commit}"
    except Exception:
        return None


def version_string() -> str:
    """Banner string (reference: src/SpydrPick_options.cpp:58-79 prints
    version | git revision | SIMD level | build date; this engine's
    equivalents are the jax/jaxlib versions and the active backend)."""
    import jax

    parts = [f"spydrpick-jax version {__version__}"]
    rev = _git_revision()
    if rev:
        parts.append(f"revision {rev}")
    parts.append(f"jax {jax.__version__}")
    try:
        import jaxlib

        parts.append(f"jaxlib {jaxlib.__version__}")
    except Exception:
        pass
    backend = jax.default_backend()
    devs = jax.devices()
    kind = devs[0].device_kind if devs else "?"
    parts.append(f"{backend} backend ({len(devs)}x {kind})")
    return " | ".join(parts)
