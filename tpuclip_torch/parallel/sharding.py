"""Parameter sharding rules (PyTorch port of ``tpuclip/parallel/sharding.py``).

tpuclip's rule table splits attention heads and the MLP hidden dimension
over the ``model`` axis (tensor parallelism) and replicates everything
else. :func:`param_shardings` applies the same table to the port's
per-layer parameter names, in PyTorch's (out, in) weight layout: a spec
names, per dimension, the mesh axis it splits over (``MODEL_AXIS``) or
None. tpuclip's encoder leaves carry a leading layer axis; the port's
layers are separate tensors, so its specs have none.

:func:`shard_params` places the model on the mesh: one replica per local
data shard. With ``model_parallelism == 1`` each replica is the whole
model on its data device (what ``train`` uses; tpuclip's ``train`` also
builds a model axis of 1). Above 1 each replica is split over its mesh
row by the table (``tensor_parallel.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch

from tpuclip_torch.models.siglip import SiglipModel
from tpuclip_torch.parallel.mesh import MODEL_AXIS, Mesh

Spec = Tuple[Optional[str], ...]

# The port's name inside a layer (or the vision head) → its spec, tpuclip's
# _ENCODER_RULES with each (in, out) kernel's spec reversed.
_RULES: Dict[str, Spec] = {
    "attn.q.weight": (MODEL_AXIS, None), "attn.q.bias": (MODEL_AXIS,),
    "attn.k.weight": (MODEL_AXIS, None), "attn.k.bias": (MODEL_AXIS,),
    "attn.v.weight": (MODEL_AXIS, None), "attn.v.bias": (MODEL_AXIS,),
    "attn.o.weight": (None, MODEL_AXIS), "attn.o.bias": (None,),
    "mlp.fc1.weight": (MODEL_AXIS, None), "mlp.fc1.bias": (MODEL_AXIS,),
    "mlp.fc2.weight": (None, MODEL_AXIS), "mlp.fc2.bias": (None,),
    "ln1.weight": (None,), "ln1.bias": (None,),
    "ln2.weight": (None,), "ln2.bias": (None,),
}
_SCOPES = (".encoder.layers.", "vision.head.")


def _spec_for(name: str, p: torch.Tensor) -> Spec:
    for scope in _SCOPES:
        if scope in name:
            tail = name.split(scope, 1)[1]
            if scope == ".encoder.layers.":
                tail = tail.split(".", 1)[1]  # drop the layer index
            if tail in _RULES:
                return _RULES[tail]
    # embeddings, LayerNorms, the probe, the text head, logit scale / bias
    return (None,) * p.dim()


def param_shardings(model: SiglipModel, mesh: Mesh) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of ``model``."""
    return {name: _spec_for(name, p) for name, p in model.named_parameters()}


def shard_params(model: SiglipModel, mesh: Mesh) -> List[SiglipModel]:
    """One replica of ``model`` per local data shard, the first on the lead
    row. With ``model_parallelism == 1`` each is on its data device (the
    first is ``model`` itself, moved to the lead device); above 1 each is a
    tensor-parallel copy over its row, ``mesh.devices[j * mp : (j + 1) * mp]``
    (:func:`~tpuclip_torch.parallel.tensor_parallel.to_tensor_parallel`),
    and ``model`` is left as it is."""
    mp = mesh.model_parallelism
    if mp > 1:
        from tpuclip_torch.parallel.tensor_parallel import to_tensor_parallel

        return [to_tensor_parallel(model, mesh.devices[j * mp : (j + 1) * mp]) for j in range(len(mesh.data_devices))]
    lead = model.to(mesh.lead)
    return [lead] + [copy.deepcopy(lead).to(dev) for dev in mesh.data_devices[1:]]
