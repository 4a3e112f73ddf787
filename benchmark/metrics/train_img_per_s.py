"""train_img_per_s: training images of all steps of the window over the whole window."""


def read(run):
    return run.window.rate()
