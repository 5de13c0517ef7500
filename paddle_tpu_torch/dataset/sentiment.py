"""Movie-review sentiment (paddle_tpu/dataset/sentiment.py; parity:
python/paddle/v2/dataset/sentiment.py).
Same schema as imdb with a smaller dict."""

from paddle_tpu_torch.dataset import imdb

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
WORD_DICT_SIZE = 5147


def get_word_dict():
    return {"w%d" % i: i for i in range(WORD_DICT_SIZE)}


def train(synthetic_size=NUM_TRAINING_INSTANCES):
    return imdb._synthetic(synthetic_size, 0, WORD_DICT_SIZE, 5, 50)


def test(synthetic_size=NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES):
    return imdb._synthetic(synthetic_size, 13, WORD_DICT_SIZE, 5, 50)
