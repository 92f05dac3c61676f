/* In-memory Ogg/Opus decode + encode over the system libopus + libogg.
 *
 * The reference's AudioSegment decodes opus through libsndfile>=1.1 or
 * pydub. Only libopus and libogg are assumed (no libopusfile, no
 * headers), so the Ogg encapsulation (RFC 7845) is done
 * here directly: demux pages -> packets, parse OpusHead (preskip, channel
 * count, mapping family 0), decode at 48 kHz, honor end-trimming via the
 * final granulepos. The encoder is the exact inverse and exists so tests
 * and corpus generators can produce real .opus files.
 *
 * Built at first use by conformer_nemo_tpu_torch/ops/build.py and linked
 * against the versioned .so files by full path (no dev symlinks needed).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t ogg_int64_t;

/* --- stable libogg ABI (ogg/ogg.h) --- */
typedef struct {
  unsigned char *header;
  long header_len;
  unsigned char *body;
  long body_len;
} ogg_page;

typedef struct {
  unsigned char *packet;
  long bytes;
  long b_o_s;
  long e_o_s;
  ogg_int64_t granulepos;
  ogg_int64_t packetno;
} ogg_packet;

/* ogg_sync_state (32 B) / ogg_stream_state (~408 B): opaque oversized */
typedef struct { char opaque[128]; } ogg_sync_state;
typedef struct { char opaque[1024]; } ogg_stream_state;

extern int ogg_sync_init(ogg_sync_state *);
extern char *ogg_sync_buffer(ogg_sync_state *, long);
extern int ogg_sync_wrote(ogg_sync_state *, long);
extern int ogg_sync_pageout(ogg_sync_state *, ogg_page *);
extern int ogg_sync_clear(ogg_sync_state *);
extern int ogg_stream_init(ogg_stream_state *, int serialno);
extern int ogg_stream_pagein(ogg_stream_state *, ogg_page *);
extern int ogg_stream_packetout(ogg_stream_state *, ogg_packet *);
extern int ogg_stream_packetin(ogg_stream_state *, ogg_packet *);
extern int ogg_stream_flush(ogg_stream_state *, ogg_page *);
extern int ogg_stream_pageout(ogg_stream_state *, ogg_page *);
extern int ogg_stream_clear(ogg_stream_state *);
extern int ogg_page_serialno(const ogg_page *);

/* --- libopus (opus/opus.h) --- */
typedef struct OpusDecoder OpusDecoder;
typedef struct OpusEncoder OpusEncoder;
extern OpusDecoder *opus_decoder_create(int32_t fs, int channels, int *error);
extern int opus_decode(OpusDecoder *, const unsigned char *, int32_t,
                       int16_t *, int frame_size, int decode_fec);
extern void opus_decoder_destroy(OpusDecoder *);
extern OpusEncoder *opus_encoder_create(int32_t fs, int channels,
                                        int application, int *error);
extern int32_t opus_encode(OpusEncoder *, const int16_t *, int frame_size,
                           unsigned char *, int32_t max_bytes);
extern int opus_encoder_ctl(OpusEncoder *, int request, ...);
extern void opus_encoder_destroy(OpusEncoder *);

#define OPUS_APPLICATION_AUDIO 2049
#define OPUS_GET_LOOKAHEAD_REQUEST 4027
#define OPUS_SET_BITRATE_REQUEST 4002

static uint16_t rd16(const unsigned char *p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}
static uint32_t rd32(const unsigned char *p) {
  return (uint32_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24));
}

/* Decode a whole in-memory Ogg/Opus stream to interleaved s16 at 48 kHz.
 * Returns 0 on success. *rate is always 48000 (Opus decode rate). */
int ogg_opus_decode(const unsigned char *data, int64_t len, int16_t **out,
                    int64_t *n_frames, int *channels, int *rate) {
  ogg_sync_state oy;
  ogg_stream_state os;
  ogg_page og;
  ogg_packet op;
  int stream_open = 0, header_done = 0, ch = 0, preskip = 0, rc = -1;
  ogg_int64_t packetno = 0, last_granule = -1;
  OpusDecoder *dec = NULL;
  size_t cap = 1 << 16, used = 0; /* int16 count */
  int16_t *pcm = (int16_t *)malloc(cap * sizeof(int16_t));
  if (!pcm) return -2;

  ogg_sync_init(&oy);
  char *buf = ogg_sync_buffer(&oy, (long)len);
  if (!buf) goto done;
  memcpy(buf, data, (size_t)len);
  ogg_sync_wrote(&oy, (long)len);

  while (ogg_sync_pageout(&oy, &og) == 1) {
    if (!stream_open) {
      ogg_stream_init(&os, ogg_page_serialno(&og));
      stream_open = 1;
    }
    ogg_stream_pagein(&os, &og);
    while (ogg_stream_packetout(&os, &op) == 1) {
      if (packetno == 0) {
        if (op.bytes < 19 || memcmp(op.packet, "OpusHead", 8) != 0) goto done;
        ch = op.packet[9];
        preskip = (int)rd16(op.packet + 10);
        (void)rd32(op.packet + 12); /* original input rate: informational */
        if (ch < 1 || ch > 2 || op.packet[18] != 0) goto done; /* mapping 0 */
        int err = 0;
        dec = opus_decoder_create(48000, ch, &err);
        if (!dec || err != 0) goto done;
      } else if (packetno == 1) {
        if (op.bytes < 8 || memcmp(op.packet, "OpusTags", 8) != 0) goto done;
        header_done = 1;
      } else {
        if (!header_done || !dec) goto done;
        if (used + (size_t)(5760 * ch) > cap) {
          while (used + (size_t)(5760 * ch) > cap) cap *= 2;
          int16_t *np = (int16_t *)realloc(pcm, cap * sizeof(int16_t));
          if (!np) goto done;
          pcm = np;
        }
        int got = opus_decode(dec, op.packet, (int32_t)op.bytes,
                              pcm + used, 5760, 0);
        if (got < 0) goto done;
        used += (size_t)got * (size_t)ch;
        if (op.granulepos >= 0) last_granule = op.granulepos;
      }
      packetno++;
    }
  }
  if (!dec || packetno < 3) goto done;
  {
    int64_t frames = (int64_t)(used / (size_t)ch);
    /* RFC 7845: skip preskip, trim tail to final granulepos - preskip */
    int64_t start = preskip < frames ? preskip : frames;
    int64_t end = frames;
    if (last_granule >= 0) {
      int64_t want = start + (last_granule - preskip);
      if (want < end) end = want;
    }
    if (end < start) end = start;
    int64_t keep = end - start;
    memmove(pcm, pcm + (size_t)start * ch, (size_t)keep * ch * sizeof(int16_t));
    *out = pcm;
    *n_frames = keep;
    *channels = ch;
    *rate = 48000;
    rc = 0;
  }
done:
  if (rc != 0) free(pcm);
  if (dec) opus_decoder_destroy(dec);
  if (stream_open) ogg_stream_clear(&os);
  ogg_sync_clear(&oy);
  return rc;
}

void ogg_opus_free(int16_t *p) { free(p); }

/* Encode mono s16 at input_rate (8/12/16/24/48 kHz) -> Ogg/Opus bytes.
 * Caller frees *out with ogg_opus_free_bytes. */
int ogg_opus_encode(const int16_t *pcm, int64_t n, int input_rate,
                    int bitrate_bps, unsigned char **out, int64_t *out_len) {
  int err = 0, rc = -1;
  OpusEncoder *enc = opus_encoder_create(input_rate, 1, OPUS_APPLICATION_AUDIO, &err);
  if (!enc || err != 0) return -1;
  opus_encoder_ctl(enc, OPUS_SET_BITRATE_REQUEST, bitrate_bps);
  int lookahead = 0;
  opus_encoder_ctl(enc, OPUS_GET_LOOKAHEAD_REQUEST, &lookahead);
  int preskip48 = (int)((int64_t)lookahead * 48000 / input_rate);

  ogg_stream_state os;
  ogg_page og;
  ogg_packet op;
  ogg_stream_init(&os, 0x5550);
  size_t cap = 1 << 16, used = 0;
  unsigned char *obuf = (unsigned char *)malloc(cap);
  if (!obuf) {
    opus_encoder_destroy(enc);
    ogg_stream_clear(&os);
    return -2;
  }
#define EMIT(ptr, len_)                                                        \
  do {                                                                         \
    while (used + (size_t)(len_) > cap) {                                      \
      cap *= 2;                                                                \
      unsigned char *nb = (unsigned char *)realloc(obuf, cap);                 \
      if (!nb) goto fail;                                                      \
      obuf = nb;                                                               \
    }                                                                          \
    memcpy(obuf + used, (ptr), (size_t)(len_));                                \
    used += (size_t)(len_);                                                    \
  } while (0)

  /* OpusHead */
  unsigned char head[19];
  memcpy(head, "OpusHead", 8);
  head[8] = 1; /* version */
  head[9] = 1; /* channels */
  head[10] = (unsigned char)(preskip48 & 0xFF);
  head[11] = (unsigned char)(preskip48 >> 8);
  head[12] = (unsigned char)(input_rate & 0xFF);
  head[13] = (unsigned char)((input_rate >> 8) & 0xFF);
  head[14] = (unsigned char)((input_rate >> 16) & 0xFF);
  head[15] = (unsigned char)((input_rate >> 24) & 0xFF);
  head[16] = head[17] = 0; /* gain */
  head[18] = 0;            /* mapping family */
  op.packet = head;
  op.bytes = 19;
  op.b_o_s = 1;
  op.e_o_s = 0;
  op.granulepos = 0;
  op.packetno = 0;
  ogg_stream_packetin(&os, &op);
  while (ogg_stream_flush(&os, &og) != 0) {
    EMIT(og.header, og.header_len);
    EMIT(og.body, og.body_len);
  }
  /* OpusTags: magic + vendor_len(4 LE) + vendor + user_comment_count(4 LE) */
  unsigned char tags_full[21];
  memcpy(tags_full, "OpusTags", 8);
  tags_full[8] = 5; /* vendor_len = strlen("cntpu") */
  tags_full[9] = tags_full[10] = tags_full[11] = 0;
  memcpy(tags_full + 12, "cntpu", 5);
  memset(tags_full + 17, 0, 4); /* zero user comments */
  op.packet = tags_full;
  op.bytes = 21;
  op.b_o_s = 0;
  op.granulepos = 0;
  op.packetno = 1;
  ogg_stream_packetin(&os, &op);
  while (ogg_stream_flush(&os, &og) != 0) {
    EMIT(og.header, og.header_len);
    EMIT(og.body, og.body_len);
  }

  int frame = input_rate / 50; /* 20 ms */
  int16_t *padded = NULL;
  /* pad past n by the encoder lookahead so the decoder can reconstruct all
   * n samples after preskip trimming (gapless, opusenc semantics) */
  int64_t total = ((n + lookahead + frame - 1) / frame) * frame;
  padded = (int16_t *)calloc((size_t)total, sizeof(int16_t));
  if (!padded) goto fail;
  memcpy(padded, pcm, (size_t)n * sizeof(int16_t));
  unsigned char pkt[4000];
  ogg_int64_t granule = preskip48;
  for (int64_t off = 0; off < total; off += frame) {
    int32_t nb = opus_encode(enc, padded + off, frame, pkt, sizeof(pkt));
    if (nb < 0) {
      free(padded);
      goto fail;
    }
    int last = off + frame >= total;
    granule += (ogg_int64_t)frame * 48000 / input_rate;
    op.packet = pkt;
    op.bytes = nb;
    op.b_o_s = 0;
    /* final granulepos encodes the true (unpadded) length per RFC 7845 */
    op.e_o_s = last;
    op.granulepos = last ? preskip48 + (ogg_int64_t)n * 48000 / input_rate
                         : granule;
    op.packetno = 2 + off / frame;
    ogg_stream_packetin(&os, &op);
    while ((last ? ogg_stream_flush(&os, &og)
                 : ogg_stream_pageout(&os, &og)) != 0) {
      EMIT(og.header, og.header_len);
      EMIT(og.body, og.body_len);
    }
  }
  free(padded);
  *out = obuf;
  *out_len = (int64_t)used;
  rc = 0;
fail:
  if (rc != 0) free(obuf);
  opus_encoder_destroy(enc);
  ogg_stream_clear(&os);
  return rc;
#undef EMIT
}

void ogg_opus_free_bytes(unsigned char *p) { free(p); }
