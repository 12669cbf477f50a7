"""Engine, device-IO program and runtime control (torch twin)."""
