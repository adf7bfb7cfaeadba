from .barostats import (
    BarostatHook, NHCBarostatAnisotropic, NHCBarostatIsotropic, PILEBarostat,
)
from .basic_hooks import DeviceHook, RemoveCOMMotion, SimulationHook, WrapPositions
from .callback_hooks import Checkpoint, FileLogger, TensorBoardLoggerMD
from .thermostats import (
    BerendsenThermostat, GLEThermostat, LangevinThermostat, NHCThermostat,
    ThermostatHook,
)
from .thermostats_rpmd import (
    NHCRingPolymerThermostat, PIGLETThermostat, PILEGlobalThermostat,
    PILELocalThermostat, RPMDGLEThermostat, TRPMDThermostat,
)

__all__ = [
    "BarostatHook", "NHCBarostatAnisotropic", "NHCBarostatIsotropic",
    "PILEBarostat",
    "DeviceHook", "RemoveCOMMotion", "SimulationHook", "WrapPositions",
    "Checkpoint", "FileLogger", "TensorBoardLoggerMD",
    "BerendsenThermostat", "GLEThermostat", "LangevinThermostat",
    "NHCThermostat", "ThermostatHook",
    "NHCRingPolymerThermostat", "PIGLETThermostat", "PILEGlobalThermostat",
    "PILELocalThermostat", "RPMDGLEThermostat", "TRPMDThermostat",
]
