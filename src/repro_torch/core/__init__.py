"""vPOD core — the paper's contribution as a composable PyTorch runtime
layer (the port of ``repro.core``).

FPGA-virtualization concept → module map:
  PRR                → vslice.VSlice / Floorplanner
  shell (DMA, IRQ)   → shell.TransferEngine / CompletionQueue
  PR controller      → reconfig.CompileService / ProgramLoader / Bitfile
  software MMU       → mmu.SegmentPool (bitmap / freelist / buddy)
  VMM                → vmm.VMM (fev / bev / hybrid / wfq / slo policies)
  MMD guest API      → tenant.GuestDevice (the paper's 8 operators)
  interposition      → interposition.OpLog / TenantCheckpointer
  criteria           → criteria.report

Not ported yet: the elastic autoscaler (``autoscaler``/``elastic``).
"""
from repro_torch.core.criteria import CriteriaReport, report
from repro_torch.core.mmu import (SEGMENT_BYTES, IsolationViolation,
                                  MMUError, OutOfMemory, QuotaExceeded,
                                  SegmentPool)
from repro_torch.core.reconfig import (Bitfile, CompileService,
                                       LegalityError, ProgramLoader,
                                       ProgramRequest)
from repro_torch.core.scheduler import (PRIORITY_HIGH, PRIORITY_LOW,
                                        PRIORITY_NORMAL, AdmissionPressure,
                                        BrokerPlane, DataPlane,
                                        PassthroughPlane, SLOPlane, WFQPlane,
                                        make_data_plane)
from repro_torch.core.shell import CompletionQueue, TransferEngine
from repro_torch.core.tenant import GuestDevice, Tenant
from repro_torch.core.vmm import VMM, AdmissionError
from repro_torch.core.vslice import Floorplanner, SliceSpec, VSlice

__all__ = [
    "VMM", "AdmissionError", "AdmissionPressure", "Bitfile",
    "BrokerPlane", "CompileService", "CompletionQueue", "CriteriaReport",
    "DataPlane", "Floorplanner", "GuestDevice",
    "IsolationViolation", "LegalityError", "MMUError", "OutOfMemory",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL", "PassthroughPlane",
    "ProgramLoader", "ProgramRequest", "QuotaExceeded", "SEGMENT_BYTES",
    "SLOPlane", "SegmentPool", "SliceSpec", "Tenant", "TransferEngine",
    "VSlice", "WFQPlane", "make_data_plane", "report",
]
