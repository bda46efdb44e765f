"""Host-side event IO: RAW decoding, packet iteration, device prefetch."""

from xmaps.io.evt_decoder import EvtDecoder, decode_file  # noqa: F401
from xmaps.io.event_iterator import FileEventsIterator  # noqa: F401
from xmaps.io.biases import Biases, load_bias_file  # noqa: F401
from xmaps.io.prefetch import HostStagingPool  # noqa: F401
