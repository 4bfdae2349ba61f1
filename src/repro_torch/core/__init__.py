"""STrack per-flow logic (CC, spray, reliability) batched over flows."""
