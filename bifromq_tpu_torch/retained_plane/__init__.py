"""The retained plane (port of ``bifromq_tpu/retained_plane/``): the
in-place patching of the retained trie's arenas. The scan plane, its
result cache, the retained delta log and the drain governor are not
ported yet."""

from __future__ import annotations

from .patched import RetainedPatchableTrie

__all__ = ["RetainedPatchableTrie"]
