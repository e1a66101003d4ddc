"""Collaboration layer: transports, the client cache and the map-fusion server."""
