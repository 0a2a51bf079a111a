"""Helpers of the port: visualisation, the dormant LSS tools and Kalman
filter (tools.py), small tensor utilities (network.py), the reference
checkpoint's names (torch_convert.py)."""
