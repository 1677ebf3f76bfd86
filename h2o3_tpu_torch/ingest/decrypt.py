"""DecryptionTool registry: transparent decryption during parse (copy of
h2o3_tpu/ingest/decrypt.py).

Reference: water/parser/DecryptionTool.java:1 (+ GenericDecryptionTool,
NullDecryptionTool): /3/DecryptionSetup registers a tool under a key; Parse
pipes file bytes through it before format detection.

Built in: the null tool (passthrough — reference default). AES cipher specs
need the optional `cryptography` package; without it registration of an AES
tool raises an actionable error rather than silently storing a no-op.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_TOOLS: Dict[str, dict] = {}

NULL_TOOL = "water.parser.NullDecryptionTool"


def register_tool(tool_id: str, tool_class: str, params: dict) -> str:
    """Register a decryption tool; returns the tool id."""
    if tool_class in ("", NULL_TOOL, "null"):
        _TOOLS[tool_id] = {"class": NULL_TOOL, "params": dict(params)}
        return tool_id
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher  # noqa: F401
    except ImportError:
        raise ValueError(
            f"decryption tool {tool_class!r} needs the 'cryptography' "
            "package on the server; only the null (passthrough) tool is "
            "built in") from None
    _TOOLS[tool_id] = {"class": tool_class, "params": dict(params)}
    return tool_id


def get_tool(tool_id: Optional[str]) -> Optional[Callable[[bytes], bytes]]:
    """Decryptor function for a registered tool id (None → passthrough)."""
    if not tool_id:
        return None
    ent = _TOOLS.get(tool_id)
    if ent is None:
        raise KeyError(f"decryption tool {tool_id!r} not registered")
    if ent["class"] == NULL_TOOL:
        return lambda data: data
    raise NotImplementedError(
        f"cipher tool {ent['class']!r} registered but no cipher backend "
        "wired — install 'cryptography'")
