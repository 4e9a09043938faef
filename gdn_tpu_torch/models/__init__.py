from gdn_tpu_torch.models.dtod import DtoDNet
from gdn_tpu_torch.models.rtod import RtoDNet
from gdn_tpu_torch.models.encoder import Encoder
from gdn_tpu_torch.models.decoder import Decoder
