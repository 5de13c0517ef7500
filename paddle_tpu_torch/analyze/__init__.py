"""Static checks (paddle_tpu/analyze): the port holds only the device
memory estimate that bundles record and fleets size against
(:mod:`paddle_tpu_torch.analyze.topology_check`)."""
