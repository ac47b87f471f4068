"""Quickstart: the paper's DMM in 60 lines, on the PyTorch port.

Builds a schema registry, a mapping matrix, compacts it both ways, maps a
CDC event through Algorithm 6, and runs one automated schema-evolution
update -- the complete METL lifecycle at toy scale.

The port's copy of ``examples/quickstart.py``: the numpy core
(``repro_torch.core``) runs on the host, so it takes no ``--device``, and
it prints the reference's text line for line.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core.dmm import (
    MappingMatrix,
    Message,
    auto_update_dpm,
    dpm_size,
    map_message_dense,
    transform_to_dpm,
    transform_to_dusb,
)
from repro_torch.core.registry import Registry

# 1. Two metadata trees: extraction schemas (domain) and the CDM (range).
reg = Registry()
payments_v1 = reg.add_schema(reg.domain, 1, ["id", "value", "currency", "time"])
payment_be = reg.add_schema(reg.range, 1, ["Payment id", "Amount", "Time of the payment"])

# 2. The mapping matrix: attribute-level 1:1 forwarding (1) or filtering (0).
matrix = MappingMatrix(reg)
a = {x.name: x.uid for x in payments_v1.attributes}
c = {x.name: x.uid for x in payment_be.attributes}
matrix.set(c["Payment id"], a["id"], 1)
matrix.set(c["Amount"], a["value"], 1)
matrix.set(c["Time of the payment"], a["time"], 1)  # "currency" is filtered

# 3. Compact: balanced (DPM, in-memory) and aggressive (DUSB, storage).
dpm = transform_to_dpm(matrix)
dusb = transform_to_dusb(matrix)
print(f"matrix {matrix.M.shape} ({matrix.M.size} elements) "
      f"-> DPM {dpm_size(dpm)} elements, DUSB {sum(len(b) for s in dusb.values() for _, b in s)}")

# 4. Map a CDC event (paper Figure 2) with Algorithm 6.
event = Message(
    state=reg.state, schema_id=1, version=1,
    payload={a["id"]: 32201, a["value"]: 10.00, a["time"]: 1634052484031131},
)
for out in map_message_dense(dpm, reg, event):
    names = {x.uid: x.name for x in reg.range.get(out.schema_id, out.version).attributes}
    print("mapped message:", {names[k]: v for k, v in out.payload.items()})

# 5. Schema evolution: v2 renames nothing, drops "currency", adds "iban".
reg.evolve(reg.domain, 1, keep=["id", "value", "time"], add=["iban"])
dpm2, report = auto_update_dpm(dpm, reg, ("added_domain", 1, 2))
print(f"auto-update: +{len(report.new_blocks)} blocks, "
      f"shrunk={len(report.shrunk_blocks)}, needs_review={report.needs_user_review}")

# 6. The new version maps immediately -- values were copied along equivalences.
a2 = {x.name: x.uid for x in reg.domain.get(1, 2).attributes}
event_v2 = Message(
    state=reg.state, schema_id=1, version=2,
    payload={a2["id"]: 99, a2["value"]: 20.0, a2["time"]: 1634052485000000, a2["iban"]: 42},
)
for out in map_message_dense(dpm2, reg, event_v2):
    names = {x.uid: x.name for x in reg.range.get(out.schema_id, out.version).attributes}
    print("mapped v2 message:", {names[k]: v for k, v in out.payload.items()})
