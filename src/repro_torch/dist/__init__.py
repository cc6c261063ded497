"""Gossip pulls and the consensus mix on stacked replicas (``repro/dist``)."""
