"""Version metadata of the port (a copy of ``llm_consensus_tpu/version.py``).

The version, commit and build date are module attributes, overridable at
build or install time by writing ``_build_info.py`` next to this file.
"""

__version__ = "0.1.0"
__commit__ = "none"
__date__ = "unknown"

try:  # populated by packaging, absent in a source checkout
    from llm_consensus_tpu_torch._build_info import __commit__, __date__, __version__  # noqa: F401
except ImportError:
    pass


def version_string(prog: str = "llm-consensus-torch") -> str:
    """Multi-line version banner: ``prog version``, commit, build date."""
    return f"{prog} {__version__}\n  commit: {__commit__}\n  built:  {__date__}"
