"""Request-level traffic: workload profiles, prompt synthesis, arrivals and
record/replay (the reference's ``repro.workloads`` exports)."""
from repro_torch.workloads.arrivals import (ArrivalConfig, ClosedLoop,
                                            IterationCostModel, VirtualClock,
                                            arrival_times)
from repro_torch.workloads.multimodal import (PromptProfile, RequestSpec,
                                              make_stream, profile,
                                              stream_stats, synth_request)
from repro_torch.workloads.profiles import WORKLOADS
from repro_torch.workloads.replay import load_stream, save_stream

__all__ = [
    "ArrivalConfig", "ClosedLoop", "IterationCostModel", "VirtualClock",
    "arrival_times", "PromptProfile", "RequestSpec", "make_stream",
    "profile", "stream_stats", "synth_request", "WORKLOADS",
    "load_stream", "save_stream",
]
