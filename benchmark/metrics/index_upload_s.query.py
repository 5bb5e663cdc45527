"""index_upload_s.query: seconds of the index's copy to the card in
set-up, the program's `index.upload` span total (`index_tensors`)."""
from traffic import spans


def read(traced):
    return spans.total_s("index.upload")
