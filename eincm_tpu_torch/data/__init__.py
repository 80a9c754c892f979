"""Host-side event data: the loaders (synthetic, ECD, MVSEC, DSEC),
windowing and staging. Importing it imports no h5py, PIL or imageio."""

from eincm_tpu_torch.data.windowing import adjust_event_window
from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
from eincm_tpu_torch.data.ecd import ECDDataLoader
from eincm_tpu_torch.data.mvsec import MVSECDataLoader
from eincm_tpu_torch.data.dsec import DSECDataLoader
from eincm_tpu_torch.data.staging import stage_datasample, StagedSample
