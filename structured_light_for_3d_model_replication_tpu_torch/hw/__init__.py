"""Hardware/device-communication layer (the port's copy of the JAX
package's ``hw/``).

Three transports with the reference's exact wire protocols — pull-mode HTTP
command channel (`server/server.py`), push-mode Android Camera2 host client
(`android_camera_host/`), serial turntable (`server/arduino.py` /
`ESP_code.ino`) — plus headless virtual equivalents for every device so the
full capture pipeline runs without hardware (:mod:`.rig`), and the fault
injectors of the capture path and the serving layer (:mod:`.faults`).

Everything here is host code (stdlib and numpy); nothing runs on the card.
`WindowProjector` and `LocalCamera` need cv2 and `SerialTurntable` needs
pyserial; each imports lazily inside its class so this package (and the
virtual rig) works on machines without them.
"""

from .camera import (  # noqa: F401
    CameraSettings,
    LocalCamera,
    PullCamera,
    PushCamera,
    SyntheticCamera,
)
from .command_server import CommandChannel, CommandServer  # noqa: F401
from .faults import (  # noqa: F401
    CallSchedule,
    FaultPlan,
    FaultRule,
    FlakyCamera,
    FlakyChannel,
    FlakyTurntable,
)
from .projector import VirtualProjector, WindowProjector  # noqa: F401
from .rig import VirtualRig  # noqa: F401
from .turntable import SerialTurntable, SimulatedTurntable, TurntableError  # noqa: F401
