"""Host waits on the card per session step: stream, event and device
synchronisations and blocking copies that the host called between the
first traced step's start and the last one's end."""


def read(view):
    if not view.has_device or view.stretch() is None:
        return None
    return len(view.syncs_in_stretch()) / view.steps
