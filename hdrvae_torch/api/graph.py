"""A workflow-graph executor, as ``hdrvae/api/graph.py``.

It runs workflow JSON in the shape of ``workflow_examples/``: a list of
nodes, each with a ``type`` (a key of the registry), ``inputs`` mapping
socket names to literals or ``[source_node_id, output_index]`` links, and
``widgets_values`` (a list in INPUT_TYPES declaration order, or a dict by
name).  ComfyUI's UI-export format (a ``links`` array, inputs as a list)
is converted first.

Execution is a topological walk with memoized node outputs; each node
class is instantiated and its FUNCTION method called: the ComfyUI node
protocol that the port's nodes (``api/nodes.py``) implement.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Mapping, Optional, Tuple

logger = logging.getLogger(__name__)


class GraphError(RuntimeError):
    pass


def is_comfyui_format(workflow: Mapping[str, Any]) -> bool:
    """ComfyUI's UI-export format: a top-level ``links`` array and per-node
    ``inputs`` given as a LIST of {name, link} dicts."""
    if "links" not in workflow or "nodes" not in workflow:
        return False
    for node in workflow["nodes"]:
        ins = node.get("inputs")
        if isinstance(ins, list):
            return True
        if isinstance(ins, dict):
            return False
    return True  # links array + no dict-style inputs anywhere


def convert_comfyui_workflow(workflow: Mapping[str, Any],
                             registry: Mapping[str, type]
                             ) -> Dict[str, Any]:
    """Convert a ComfyUI UI-export graph to the executor's internal shape.

    - ``links`` rows ``[link_id, src_node, src_slot, dst_node, dst_slot,
      type]`` become per-input ``[src_node_id, src_slot]`` references.
    - Node types NOT in the registry (UNETLoader, KSampler, CLIP encoders,
      ...) are dropped from the executable graph; links sourced from them
      are rewritten to external-input references keyed by the source
      node's TYPE (or ``type:id`` when a type appears more than once), so
      callers supply e.g. ``{"KSampler": ({"samples": latent},),
      "VAELoader": (vae,)}``.
    - Positional ``widgets_values`` are adapted per node class: classes may
      define ``adapt_widgets(list) -> dict`` to accept LEGACY signatures
      (the old 4-widget HDRVAEDecode and 6-widget LinearEXRExport
      forms).
    """
    links = {row[0]: (row[1], row[2]) for row in workflow.get("links", [])
             if row is not None}
    known = [n for n in workflow["nodes"] if n["type"] in registry]
    unknown = {n["id"]: n for n in workflow["nodes"]
               if n["type"] not in registry}

    type_counts: Dict[str, int] = {}
    for n in unknown.values():
        type_counts[n["type"]] = type_counts.get(n["type"], 0) + 1

    def external_key(node_id) -> str:
        node = unknown[node_id]
        if type_counts[node["type"]] > 1:
            return f"{node['type']}:{node_id}"
        return node["type"]

    out_nodes = []
    referenced: set = set()
    for node in known:
        inputs: Dict[str, Any] = {}
        for inp in node.get("inputs") or []:
            link_id = inp.get("link")
            if link_id is None or link_id not in links:
                continue
            src, slot = links[link_id]
            if src in unknown:
                inputs[inp["name"]] = [external_key(src), slot]
                referenced.add(external_key(src))
            else:
                inputs[inp["name"]] = [src, slot]
        converted = {"id": node["id"], "type": node["type"],
                     "inputs": inputs}
        widgets = node.get("widgets_values")
        if isinstance(widgets, list):
            cls = registry[node["type"]]
            adapt = getattr(cls, "adapt_widgets", None)
            converted["widgets_values"] = (adapt(widgets) if adapt
                                           else widgets)
        elif widgets is not None:
            converted["widgets_values"] = widgets
        out_nodes.append(converted)

    # only keys the executable nodes actually reference: upstream-only
    # drops (CLIP encoders feeding a dropped KSampler) need no external
    return {"nodes": out_nodes, "external_keys": sorted(referenced)}


def _input_names_in_order(node_cls) -> List[str]:
    """Socket/widget names in INPUT_TYPES declaration order (required then
    optional), excluding hidden."""
    it = node_cls.INPUT_TYPES()
    names = list(it.get("required", {}))
    names += list(it.get("optional", {}))
    return names


_WIDGET_PRIMITIVES = frozenset({"INT", "FLOAT", "STRING", "BOOLEAN"})


def _widget_names_in_order(node_cls) -> List[str]:
    """Names of the inputs that own a widget SLOT in ``widgets_values``,
    in declaration order.  ComfyUI's rule is a whitelist: a slot exists
    only for combo inputs (the type is a list of choices) and primitive
    types (INT/FLOAT/STRING/BOOLEAN); every other type string — LATENT,
    IMAGE, and any custom socket type a third-party registry declares —
    is a socket with no slot.  Widget inputs the user converted to
    linked inputs DO keep their slot (the stale serialized value stays
    in the list and must still consume its position)."""
    it = node_cls.INPUT_TYPES()
    entries = list((it.get("required") or {}).items())
    entries += list((it.get("optional") or {}).items())
    names = []
    for name, spec in entries:
        kind = spec[0] if isinstance(spec, (tuple, list)) else spec
        if (isinstance(kind, (list, tuple))
                or (isinstance(kind, str) and kind in _WIDGET_PRIMITIVES)):
            names.append(name)
    return names


def _is_link(value: Any) -> bool:
    return (isinstance(value, (list, tuple)) and len(value) == 2
            and isinstance(value[1], int) and not isinstance(value[0], dict))


class GraphExecutor:
    """Executes a node graph against a registry of node classes."""

    def __init__(self, registry: Optional[Mapping[str, type]] = None,
                 external_inputs: Optional[Dict[str, Any]] = None):
        if registry is None:
            from hdrvae_torch.api.comfy import (BUILTIN_NODE_MAPPINGS,
                                                NODE_CLASS_MAPPINGS)
            registry = {**NODE_CLASS_MAPPINGS, **BUILTIN_NODE_MAPPINGS}
        self.registry = dict(registry)
        # named external sources referenced as ["name", idx] links
        self.external = dict(external_inputs or {})

    def run(self, workflow: Mapping[str, Any],
            hidden: Optional[Dict[str, Any]] = None) -> Dict[Any, Tuple]:
        if is_comfyui_format(workflow):
            workflow = convert_comfyui_workflow(workflow, self.registry)
        nodes = {n["id"]: n for n in workflow["nodes"]}
        results: Dict[Any, Tuple] = {}
        in_progress: set = set()
        hidden = hidden or {}

        def resolve(value):
            if _is_link(value):
                src, idx = value
                if src in nodes:
                    return evaluate(src)[idx]
                if src in self.external:
                    ext = self.external[src]
                    return ext[idx] if isinstance(ext, (list, tuple)) \
                        else ext
                if not isinstance(src, str):
                    # a 2-int list matching no node id (e.g. a literal
                    # [512, 512] size) is DATA, not a dangling link; only
                    # string targets are unambiguous references
                    return value
                raise GraphError(f"link target {src!r} is neither a node "
                                 f"id nor an external input")
            return value

        def evaluate(node_id):
            if node_id in results:
                return results[node_id]
            if node_id in in_progress:
                raise GraphError(f"cycle detected at node {node_id}")
            in_progress.add(node_id)
            node = nodes[node_id]
            cls = self.registry.get(node["type"])
            if cls is None:
                raise GraphError(f"unknown node type {node['type']!r}")

            kwargs: Dict[str, Any] = {}
            for name, value in (node.get("inputs") or {}).items():
                kwargs[name] = resolve(value)

            widgets = node.get("widgets_values")
            if isinstance(widgets, dict):
                # a resolved LINK always beats the stale serialized
                # widget value (ComfyUI semantics for widgets converted
                # to inputs)
                for name, value in widgets.items():
                    kwargs.setdefault(name, value)
            elif isinstance(widgets, list):
                # every widget slot consumes its position in the list —
                # including widgets converted to linked inputs (their
                # stale value stays serialized); apply only the unlinked
                # ones so the name/value alignment never shifts
                for name, value in zip(_widget_names_in_order(cls),
                                       widgets):
                    kwargs.setdefault(name, value)

            it = cls.INPUT_TYPES()
            for name, kind in (it.get("hidden") or {}).items():
                if kind in hidden:
                    kwargs[name] = hidden[kind]

            fn = getattr(cls(), cls.FUNCTION)
            logger.info("executing node %s (%s)", node_id, node["type"])
            out = fn(**kwargs)
            if not isinstance(out, tuple):
                out = (out,)
            results[node_id] = out
            in_progress.discard(node_id)
            return out

        for node_id in nodes:
            evaluate(node_id)
        return results


def run_workflow_file(path: str, *, registry=None,
                      external_inputs: Optional[Dict[str, Any]] = None,
                      hidden: Optional[Dict[str, Any]] = None
                      ) -> Dict[Any, Tuple]:
    with open(path) as f:
        workflow = json.load(f)
    return GraphExecutor(registry, external_inputs).run(workflow, hidden)
