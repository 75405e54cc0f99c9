"""The pieces of the gateway that the port's /v1 surface uses."""
