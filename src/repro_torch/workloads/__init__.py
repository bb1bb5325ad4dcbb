"""Request-level traffic: workload profiles, prompt synthesis, arrivals."""
