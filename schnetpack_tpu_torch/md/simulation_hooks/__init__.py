from .basic_hooks import DeviceHook, RemoveCOMMotion, SimulationHook, WrapPositions
from .callback_hooks import Checkpoint
from .thermostats import (
    BerendsenThermostat, GLEThermostat, LangevinThermostat, NHCThermostat,
    ThermostatHook,
)
from .thermostats_rpmd import (
    NHCRingPolymerThermostat, PIGLETThermostat, PILEGlobalThermostat,
    PILELocalThermostat, RPMDGLEThermostat, TRPMDThermostat,
)

__all__ = [
    "DeviceHook", "RemoveCOMMotion", "SimulationHook", "WrapPositions",
    "Checkpoint",
    "BerendsenThermostat", "GLEThermostat", "LangevinThermostat",
    "NHCThermostat", "ThermostatHook",
    "NHCRingPolymerThermostat", "PIGLETThermostat", "PILEGlobalThermostat",
    "PILELocalThermostat", "RPMDGLEThermostat", "TRPMDThermostat",
]
